"""Wrapper around the Hopper flash-attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas kernel in
``repro/kernels/flash_attention.py``.

On a CPU tensor it returns the plain version (``ref.attention_ref``).  On a
CUDA tensor it launches the kernel or raises; nothing falls back.

The kernel's design follows the dtype (``DESIGNS``): bf16 runs on the
tensor cores (wgmma, tiles loaded by TMA), f32 keeps a CUDA-core kernel so
that its products stay true f32 (tensor cores take f32 only as TF32).  TMA
needs q / k / v to start on a 16-byte boundary with every stride a multiple
of 16 bytes (``aligned_for_tma``); a bf16 CUDA view that is not raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
DESIGNS = {torch.bfloat16: "wgmma+tma", torch.float32: "cuda-core f32"}

# Tile classes of a (q tile, kv tile) pair; csrc/flash_attention.cu's
# tile_class mirrors this function line for line.
SKIP, FULL, PARTIAL = 0, 1, 2
_BIG = 1 << 30

launches = 0  # kernel launches since the last reset; the CPU path does not count


def tile_class(q_start: int, block_q: int, k_start: int, block_k: int, Sq: int, Sk: int,
               *, causal: bool, window: int, chunk: int) -> int:
    """SKIP if no (q, k) pair of the tile attends, FULL if every pair does
    and every key is real (the kernel needs no mask there), else PARTIAL.
    q rows past Sq are ignored (their output is not written); keys past Sk
    never attend."""
    qa, qb = q_start, min(q_start + block_q, Sq) - 1
    ka, kb = k_start, min(k_start + block_k, Sk) - 1
    if qa > qb or ka > kb:
        return SKIP
    d_lo = 0 if causal else -_BIG  # q - k must lie in [d_lo, d_hi]
    d_hi = window - 1 if window > 0 else _BIG
    # some pair attends: within one chunk that both ranges touch, the
    # differences q - k cover [a - hi, b - lo] and must meet [d_lo, d_hi]
    c_first = max(qa, ka) // chunk if chunk > 0 else 0
    c_last = min(qb, kb) // chunk if chunk > 0 else 0
    any_ = False
    c = c_first
    while c <= c_last and not any_:
        a = max(qa, c * chunk) if chunk > 0 else qa
        b = min(qb, c * chunk + chunk - 1) if chunk > 0 else qb
        lo = max(ka, c * chunk) if chunk > 0 else ka
        hi = min(kb, c * chunk + chunk - 1) if chunk > 0 else kb
        any_ = max(a - hi, d_lo) <= min(b - lo, d_hi)
        c += 1
    if not any_:
        return SKIP
    all_ = (k_start + block_k <= Sk and qa - kb >= d_lo and qb - ka <= d_hi
            and (chunk <= 0 or (qa // chunk == qb // chunk and ka // chunk == kb // chunk
                                and qa // chunk == ka // chunk)))
    return FULL if all_ else PARTIAL


def aligned_for_tma(t: torch.Tensor) -> bool:
    """True if ``t`` starts on a 16-byte boundary and its strides other than
    the last are multiples of 16 bytes, as a TMA descriptor needs."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(st * size % 16 == 0 for st in t.stride()[:-1]))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           window: int, chunk: int, softcap: float) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"q, k, v must share one dtype of {list(DTYPES)}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (kernel takes {HEAD_DIMS})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous in the head dim")
    if window < 0 or chunk < 0 or softcap < 0:
        raise ValueError("window, chunk and softcap must be >= 0")
    if q.device.type == "cuda" and q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not aligned_for_tma(t):
                raise ValueError(
                    f"{name} must start on a 16-byte boundary with strides that are multiples "
                    f"of 16 bytes for the tensor-core kernel (data_ptr % 16 = "
                    f"{t.data_ptr() % 16}, strides {tuple(t.stride())} elements of "
                    f"{t.element_size()} bytes)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, chunk: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, H, D), k / v (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype.
    Query and key positions both start at 0."""
    global launches
    _check(q, k, v, window=window, chunk=chunk, softcap=softcap)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 chunk=chunk, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0 or Sk == 0:
        return o.zero_()
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            DTYPES[q.dtype], B, Sq, Sk, H, KV, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            int(causal), int(window), int(chunk), float(softcap),
            1.0 / math.sqrt(D), stream)
    _build.check(lib, err, "flash_attention_fwd launch")
    launches += 1
    return o
