"""Wrapper around the Hopper RG-LRU kernel (``csrc/rglru.cu``), the port of
the Pallas kernel in ``repro/kernels/rglru_scan.py``.

On a CPU tensor it returns the plain version (``ref.rglru_ref``).  On a
CUDA tensor it launches the kernel or raises; nothing falls back.  A given
``h0`` is updated in place, so prefill writes each layer's final state
straight into its cache slice and decode (S = 1) updates that slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset; the CPU path does not count


def _check(x: torch.Tensor, log_a: torch.Tensor, h0: Optional[torch.Tensor]) -> None:
    if x.dim() != 3 or x.shape != log_a.shape:
        raise ValueError(f"x and log_a must be one (B, S, W) shape; got "
                         f"{tuple(x.shape)}, {tuple(log_a.shape)}")
    if x.device != log_a.device:
        raise ValueError(f"x on {x.device}, log_a on {log_a.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be one of {list(DTYPES)}; got {x.dtype}")
    if log_a.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"log_a must be float32 or x's dtype; got {log_a.dtype}")
    if x.stride(-1) != 1 or log_a.stride(-1) != 1:
        raise ValueError("x and log_a must be contiguous in the width")
    if h0 is None:
        return
    B, _, W = x.shape
    if tuple(h0.shape) != (B, W) or h0.dtype != torch.float32:
        raise ValueError(f"h0 must be f32 {(B, W)}; got {h0.dtype} {tuple(h0.shape)}")
    if h0.device != x.device:
        raise ValueError(f"h0 on {h0.device}, x on {x.device}")
    if not h0.is_contiguous():
        raise ValueError("h0 must be contiguous")


def rglru(x: torch.Tensor, log_a: torch.Tensor, h0: Optional[torch.Tensor] = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, W), log_a (B, S, W) f32 or x's dtype, h0 (B, W) f32 or None
    (zeros) -> (h (B, S, W) in x's dtype, final h (B, W) f32).

    A given ``h0`` is updated in place and returned (the reference returns
    a new one); without one a new final state is returned."""
    global launches
    _check(x, log_a, h0)
    if x.device.type == "cpu":
        out, h = ref.rglru_ref(x, log_a, h0)
        return out, (h if h0 is None else h0.copy_(h))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, S, W = x.shape
    o = torch.empty((B, S, W), dtype=x.dtype, device=x.device)
    if o.numel() == 0:
        return o, (torch.zeros((B, W), dtype=torch.float32, device=x.device)
                   if h0 is None else h0)
    h_out = h0 if h0 is not None else torch.empty((B, W), dtype=torch.float32,
                                                  device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rglru_fwd(
            x.data_ptr(), log_a.data_ptr(), None if h0 is None else h0.data_ptr(),
            o.data_ptr(), h_out.data_ptr(), DTYPES[x.dtype], DTYPES[log_a.dtype],
            B, S, W, x.stride(0), x.stride(1), log_a.stride(0), log_a.stride(1), stream)
    _build.check(lib, err, "rglru_fwd launch")
    launches += 1
    return o, h_out
