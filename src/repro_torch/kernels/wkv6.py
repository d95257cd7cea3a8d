"""Wrapper around the Hopper WKV-6 kernel (``csrc/wkv6.cu``), the port of the
Pallas kernel in ``repro/kernels/rwkv6_scan.py``.

On a CPU tensor it returns the plain version (``ref.wkv6_ref``).  On a CUDA
tensor it launches the kernel or raises; nothing falls back.  Unlike the
Pallas kernel it takes an initial state, so decode (S = 1 with the carried
state) runs through it too.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)

launches = 0  # kernel launches since the last reset; the CPU path does not count


def _check_state(name: str, s: Optional[torch.Tensor], shape: tuple, device) -> None:
    if s is None:
        return
    if tuple(s.shape) != shape or s.dtype != torch.float32:
        raise ValueError(f"{name} must be f32 {shape}; got {s.dtype} {tuple(s.shape)}")
    if s.device != device:
        raise ValueError(f"{name} on {s.device}, inputs on {device}")
    if not s.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(r, k, v, w, u, state) -> None:
    ts = (r, k, v, w)
    if any(t.dim() != 4 for t in ts):
        raise ValueError("r, k, v, w must be (B, S, H, D)")
    if not all(t.shape == r.shape for t in ts):
        raise ValueError(f"shapes do not match: {[tuple(t.shape) for t in ts]}")
    if not all(t.device == r.device for t in (k, v, w, u)):
        raise ValueError("r, k, v, w, u on different devices")
    if not all(t.dtype == r.dtype for t in ts) or r.dtype not in DTYPES:
        raise ValueError(f"r, k, v, w must share one dtype of {list(DTYPES)}; "
                         f"got {[t.dtype for t in ts]}")
    B, _, H, D = r.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported (kernel takes {HEAD_DIMS})")
    if tuple(u.shape) != (H, D) or not u.dtype.is_floating_point:
        raise ValueError(f"u must be float (H, D) = {(H, D)}; got {u.dtype} {tuple(u.shape)}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("r, k, v, w must be contiguous in the head dim")
    _check_state("state", state, (B, H, D, D), r.device)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: Optional[torch.Tensor] = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, D), u (H, D), state (B, H, D, D) f32 or None
    (zeros) -> (out (B, S, H, D) in r's dtype, final state f32).

    A given ``state`` is updated in place and returned (the reference
    returns a new one); without one a new state is returned."""
    global launches
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        out, s = ref.wkv6_ref(r, k, v, w, u, state)
        return out, (s if state is None else state.copy_(s))
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    B, S, H, D = r.shape
    o = torch.empty((B, S, H, D), dtype=r.dtype, device=r.device)
    if o.numel() == 0 or S == 0:
        return o, (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
                   if state is None else state)
    state_out = state if state is not None else torch.empty(
        (B, H, D, D), dtype=torch.float32, device=r.device)
    u32 = u.to(torch.float32).contiguous()
    lib = _build.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u32.data_ptr(),
            None if state is None else state.data_ptr(), o.data_ptr(), state_out.data_ptr(),
            DTYPES[r.dtype], B, S, H, D,
            r.stride(0), r.stride(1), r.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            w.stride(0), w.stride(1), w.stride(2),
            stream)
    _build.check(lib, err, "wkv6_fwd launch")
    launches += 1
    return o, state_out
