"""Wrapper around the Hopper WKV-6 kernels, the port of the Pallas kernel in
``repro/kernels/rwkv6_scan.py``.

On a CPU tensor it returns the plain version (``ref.wkv6_ref``).  On a CUDA
tensor it launches a kernel or raises; nothing falls back.  Unlike the
Pallas kernel it takes an initial state, so decode (S = 1 with the carried
state) runs through it too.

The kernel's design follows the dtype (``design``): bf16 runs the chunked
scan on the tensor cores (``csrc/wkv6_chunked.cu``: mma.sync with two-term
bf16 splits, inputs through a cp.async ring, which needs every stride and
the start of r, k, v, w 16-byte aligned; a bf16 CUDA view that is not
raises), f32 keeps the sequential CUDA-core kernel (``csrc/wkv6.cu``) so
that its products stay true f32.  ``wkv6_chunked`` is the chunked kernel's
arithmetic in plain PyTorch, for the tests.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import aligned_for_tma

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)
CHUNKED, SEQUENTIAL = "mma.sync chunked", "cuda-core sequential"
ENTRY = {CHUNKED: "wkv6_chunked_fwd", SEQUENTIAL: "wkv6_fwd"}
CHUNK = 16  # steps a chunk in csrc/wkv6_chunked.cu

launches = 0  # kernel launches since the last reset; the CPU path does not count
kernel_launches = {CHUNKED: 0, SEQUENTIAL: 0}  # the same, by kernel


def _check_state(name: str, s: Optional[torch.Tensor], shape: tuple, device) -> None:
    if s is None:
        return
    if tuple(s.shape) != shape or s.dtype != torch.float32:
        raise ValueError(f"{name} must be f32 {shape}; got {s.dtype} {tuple(s.shape)}")
    if s.device != device:
        raise ValueError(f"{name} on {s.device}, inputs on {device}")
    if not s.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def design(dtype: torch.dtype) -> str:
    """The kernel a CUDA call takes, at every S (prefill and the decode step
    alike): bf16 the chunked scan on the tensor cores, f32 the sequential
    CUDA-core kernel (f32 products)."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype} not supported")
    return CHUNKED if dtype == torch.bfloat16 else SEQUENTIAL


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
         u: torch.Tensor, state: Optional[torch.Tensor] = None, *,
         kernel: Optional[str] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, D), u (H, D), state (B, H, D, D) f32 or None
    (zeros) -> (out (B, S, H, D) in r's dtype, final state f32).

    A given ``state`` is updated in place and returned (the reference
    returns a new one); without one a new state is returned.  ``kernel``
    (CHUNKED or SEQUENTIAL) overrides ``design`` on the card, to compare
    the two; the chunked kernel takes bf16 only."""
    global launches
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        out, s = ref.wkv6_ref(r, k, v, w, u, state)
        return out, (s if state is None else state.copy_(s))
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    B, S, H, D = r.shape
    kernel = kernel or design(r.dtype)
    if kernel not in ENTRY:
        raise ValueError(f"unknown kernel {kernel!r}; one of {list(ENTRY)}")
    if kernel == CHUNKED:
        if r.dtype != torch.bfloat16:
            raise ValueError(f"the chunked kernel takes bf16; got {r.dtype}")
        for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
            if not aligned_for_tma(t):  # the same 16-byte rule for its cp.async copies
                raise ValueError(
                    f"{name} must start on a 16-byte boundary with strides that are multiples "
                    f"of 16 bytes for the chunked kernel (data_ptr % 16 = "
                    f"{t.data_ptr() % 16}, strides {tuple(t.stride())} elements of "
                    f"{t.element_size()} bytes)")
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
        err = getattr(lib, ENTRY[kernel])(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u32.data_ptr(),
            None if state is None else state.data_ptr(), o.data_ptr(), state_out.data_ptr(),
            DTYPES[r.dtype], B, S, H, D,
            r.stride(0), r.stride(1), r.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            w.stride(0), w.stride(1), w.stride(2),
            stream)
    _build.check(lib, err, f"{ENTRY[kernel]} launch")
    launches += 1
    kernel_launches[kernel] += 1
    return o, state_out


def _hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-term bf16 split of f32 ``x``: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, state: Optional[torch.Tensor] = None, *,
                 chunk: int = CHUNK, split: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel's arithmetic in plain PyTorch (used by the tests
    only); same arguments and results as ``ref.wkv6_ref``, a given state is
    not changed.  For one (b, h) and a chunk [b0, e) with state S at b0:

      pre_t = prod_{b0 <= tau < t} w_tau     rt_t = r_t * pre_t
      suf_s = prod_{s < tau < e} w_tau       kt_s = k_s * suf_s
      A[t, s] = sum_i r_t,i k_s,i prod_{s < tau < t} w_tau,i  (s < t),
      A[t, t] = sum_i r_t,i u_i k_t,i
      out_t = rt_t S + sum_{s <= t} A[t, s] v_s;  S <- diag(pre_e) S + kt^T v

    every decay a running product over steps inside the chunk, in f32.  With
    ``split`` the products take rt, kt, S and A as two-term bf16 splits
    (three products for rt S, two for A v and kt^T v) with f32 sums, as the
    kernel's mma.sync does; without it they are f32."""
    B, S, H, D = r.shape
    rf, kf, vf, wf = (x.float().transpose(1, 2) for x in (r, k, v, w))  # (B, H, S, D)
    uf = u.float()[None, :, None, :]
    st = (torch.zeros((B, H, D, D), dtype=torch.float32) if state is None
          else state.float().clone())
    outs = []
    for b0 in range(0, S, chunk):
        n = min(chunk, S - b0)
        rc, kc, vc, wc = (x[:, :, b0:b0 + n] for x in (rf, kf, vf, wf))
        pre = torch.ones((B, H, n + 1, D))
        for t in range(n):
            pre[:, :, t + 1] = pre[:, :, t] * wc[:, :, t]
        suf = torch.ones((B, H, n, D))
        for s in range(n - 2, -1, -1):
            suf[:, :, s] = suf[:, :, s + 1] * wc[:, :, s + 1]
        rt, kt = rc * pre[:, :, :n], kc * suf
        A = torch.zeros((B, H, n, n))
        A[:, :, range(n), range(n)] = (rc * uf * kc).sum(-1)
        q = kc.clone()  # q[s] = k_s prod_{s < tau < s + d} w_tau at lag d
        for d in range(1, n):
            A[:, :, range(d, n), range(n - d)] = (rc[:, :, d:] * q[:, :, :n - d]).sum(-1)
            q[:, :, :n - d] = q[:, :, :n - d] * wc[:, :, d:n]
        decay = pre[:, :, n, :, None]
        if split:
            (rh, rl), (sh, sl), (ah, al), (kh, kl) = map(_hi_lo, (rt, st, A, kt))
            outs.append(rh @ sh + rh @ sl + rl @ sh + ah @ vc + al @ vc)
            st = decay * st + kh.transpose(-1, -2) @ vc + kl.transpose(-1, -2) @ vc
        else:
            outs.append(rt @ st + A @ vc)
            st = decay * st + kt.transpose(-1, -2) @ vc
    out = torch.cat(outs, 2) if outs else torch.zeros_like(rf)
    return out.transpose(1, 2).to(r.dtype), st
