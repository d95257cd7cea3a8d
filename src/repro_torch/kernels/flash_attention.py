"""Wrapper around the Hopper flash-attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas kernel in
``repro/kernels/flash_attention.py``.

On a CPU tensor it returns the plain version (``ref.attention_ref``).  On a
CUDA tensor it launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)

launches = 0  # kernel launches since the last reset; the CPU path does not count


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
