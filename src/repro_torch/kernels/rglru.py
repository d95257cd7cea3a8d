"""Wrappers around the Hopper RG-LRU kernels: the forward
(``csrc/rglru.cu``), the port of the Pallas kernel in
``repro/kernels/rglru_scan.py``, and the backward (``csrc/rglru_bwd.cu``),
the port of ``jax.grad`` of ``repro.kernels.ref.rglru_ref`` (the Pallas
kernel has no backward; the reference trains through its associative scan).
``RGLRU`` joins them as a ``torch.autograd.Function``.

On CPU tensors each wrapper returns its plain version (``ref.rglru_ref``,
``ref.rglru_bwd_ref``).  On CUDA tensors it launches the kernel or raises;
nothing falls back.  A given ``h0`` is updated in place, so prefill writes
each layer's final state straight into its cache slice and decode (S = 1)
updates that slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 16  # the backward keeps h every CHUNK steps (csrc/rglru_bwd.cu's C)

# kernel launches since the last reset; the CPU path does not count
launches = 0      # forward
bwd_launches = 0  # backward


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


def rglru_bwd(x: torch.Tensor, log_a: torch.Tensor, h0: Optional[torch.Tensor],
              do: torch.Tensor, dh: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The VJP of ``rglru`` at (x, log_a, h0) for the output cotangent ``do``
    (x's dtype and shape) and the final state's ``dh`` (B, W) f32 or None
    (zeros).  ``h0`` is the initial state as it was before the forward
    updated it (f32 or None for zeros).  Returns (dx in x's dtype, dlog_a in
    log_a's dtype, dh0 (B, W) f32)."""
    global bwd_launches
    _check(x, log_a, h0)
    if tuple(do.shape) != tuple(x.shape) or do.dtype != x.dtype or do.device != x.device:
        raise ValueError(f"do must be {x.dtype} {tuple(x.shape)} on {x.device}; got "
                         f"{do.dtype} {tuple(do.shape)} on {do.device}")
    B, S, W = x.shape
    if dh is not None and (tuple(dh.shape) != (B, W) or dh.dtype != torch.float32
                           or dh.device != x.device or not dh.is_contiguous()):
        raise ValueError(f"dh must be f32 contiguous {(B, W)} on {x.device}; got "
                         f"{dh.dtype} {tuple(dh.shape)} on {dh.device}")
    if x.device.type == "cpu":
        return ref.rglru_bwd_ref(x, log_a, h0, do, dh)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x, log_a, do = (t.contiguous() for t in (x, log_a, do))
    dx, dla = torch.empty_like(x), torch.empty_like(log_a)
    dh0 = torch.empty((B, W), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, dla, (dh0.zero_() if dh is None else dh0.copy_(dh))
    # scratch: h before every CHUNK steps of each channel, f32
    ck = torch.empty((B, -(-S // CHUNK), W), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rglru_bwd(
            x.data_ptr(), log_a.data_ptr(), None if h0 is None else h0.data_ptr(),
            do.data_ptr(), None if dh is None else dh.data_ptr(), dx.data_ptr(),
            dla.data_ptr(), dh0.data_ptr(), ck.data_ptr(), DTYPES[x.dtype],
            DTYPES[log_a.dtype], B, S, W, stream)
    _build.check(lib, err, "rglru_bwd launch")
    bwd_launches += 1
    return dx, dla, dh0


class RGLRU(torch.autograd.Function):
    """Differentiable RG-LRU: ``rglru`` forward (a given state is updated in
    place, as serving does, and marked dirty) and ``rglru_bwd`` backward.
    The forward keeps a copy of the initial state, which the backward reads
    after the in-place update has overwritten it."""

    @staticmethod
    def forward(ctx, x, log_a, h0):
        h_init = None if h0 is None else h0.clone()
        out, h = rglru(x, log_a, h0)
        if h0 is not None:
            ctx.mark_dirty(h0)
        ctx.save_for_backward(x, log_a, h_init)
        return out, h

    @staticmethod
    def backward(ctx, do, dh):
        x, log_a, h_init = ctx.saved_tensors
        dx, dla, dh0 = rglru_bwd(x, log_a, h_init, do, dh.contiguous())
        return dx, dla, (None if h_init is None else dh0)
