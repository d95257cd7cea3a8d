"""Target hardware for the roofline: one NVIDIA H100 SXM5 (80 GB HBM3) in
an 8-GPU HGX node (after ``repro.launch.hw``, whose figures are a TPU
v5e's; none of them carries over).

Every figure is a data-sheet value.  The card this port is measured on is
one H100, so the two link rates below are not measured here: the
collective term of a multi-card cell is a bound from the data sheets.
"""

# dense peaks: bf16 on the tensor cores, f32 on the CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_FLOPS_BF16 = PEAK_FLOPS["bfloat16"]
HBM_BW = 3.35e12          # device-memory bytes/s
HBM_BYTES = 80 * 10**9    # device-memory capacity (80 GB)
# NVLink 4 within an HGX node: 900 GB/s a GPU both ways, 450e9 a direction
NVLINK_BW = 450e9
# NDR InfiniBand between nodes: one 400 Gb/s port a GPU, 50e9 bytes/s
IB_BW = 50e9
# the NVLink domain: where the link rate changes (the reference's pod)
CHIPS_PER_POD = 8


def bound_ms(flops: float, nbytes: float, dtype: str = "bfloat16") -> tuple[float, str]:
    """The least time for ``flops`` operations at ``dtype``'s peak and
    ``nbytes`` of device memory moved: (ms, "operations" | "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
