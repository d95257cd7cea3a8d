"""Roofline model: three terms per (arch x shape x mesh) cell (after
``repro.launch.roofline``, over the H100 figures of ``launch.hw``).

  compute term    = traced FLOPs per rank / bf16 peak
  memory term     = traced bytes per rank / HBM rate
  collective term = intra-node bytes / NVLink rate + cross-node bytes / IB rate

Every input is per rank: ``launch.trace_analysis`` counts one rank's
operations.  The *roofline fraction* is

  MODEL_FLOPS per rank / (dominant term * bf16 peak)

the MFU the step would reach if it ran exactly at its binding term.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch import hw


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Paper-convention useful FLOPs: 6 N D to train, 2 N D to infer, N the
    active parameters (6 N_active D for MoE)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    trace_flops_device: float
    useful_flops_ratio: float
    roofline_fraction: float
    step_time_lb_s: float

    def to_dict(self) -> dict:
        return dict(self.__dict__)


def analyze(cfg: ArchConfig, shape: ShapeSpec, *, n_devices: int,
            flops_per_device: float, bytes_per_device: float,
            intra_pod_coll_bytes: float, cross_pod_coll_bytes: float) -> Roofline:
    compute_s = flops_per_device / hw.PEAK_FLOPS_BF16
    memory_s = bytes_per_device / hw.HBM_BW
    collective_s = intra_pod_coll_bytes / hw.NVLINK_BW + cross_pod_coll_bytes / hw.IB_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    total = flops_per_device * n_devices
    step_lb = max(terms.values())
    return Roofline(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=mf,
        trace_flops_device=flops_per_device,
        useful_flops_ratio=mf / total if total else 0.0,
        roofline_fraction=(mf / n_devices) / (step_lb * hw.PEAK_FLOPS_BF16) if step_lb else 0.0,
        step_time_lb_s=step_lb,
    )
