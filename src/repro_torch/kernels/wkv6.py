"""Wrapper around the Hopper WKV-6 kernels, the port of the Pallas kernel in
``repro/kernels/rwkv6_scan.py``.

On a CPU tensor it returns the plain version (``ref.wkv6_ref``).  On a CUDA
tensor it launches a kernel or raises; nothing falls back.  A
``FakeTensor`` takes the fake route, as in ``flash_attention``.  Unlike the
Pallas kernel it takes an initial state, so decode (S = 1 with the carried
state) runs through it too.

The kernel's design follows the dtype (``design``): bf16 runs the chunked
scan on the tensor cores (``csrc/wkv6_chunked.cu``: mma.sync with two-term
bf16 splits, inputs through a cp.async ring, which needs every stride and
the start of r, k, v, w 16-byte aligned; a bf16 CUDA view that is not
raises), f32 keeps the sequential CUDA-core kernel (``csrc/wkv6.cu``) so
that its products stay true f32.  ``wkv6_chunked`` is the chunked kernel's
arithmetic in plain PyTorch, for the tests.

``wkv6_bwd`` wraps the backward kernels (the VJP the reference takes by
``jax.grad`` of ``ref.wkv6_ref``; the Pallas kernel has none), by dtype
(``BWD_DESIGNS``): bf16 the chunked scan on the tensor cores
(``csrc/wkv6_bwd_chunked.cu``; r, k, v, w, dO 16-byte aligned, else it
raises), f32 the CUDA-core kernel (``csrc/wkv6_bwd.cu``); on CPU tensors it
returns ``ref.wkv6_bwd_ref``.  ``wkv6_chunked_bwd`` is the chunked
backward's arithmetic in plain PyTorch, for the tests.  ``WKV6`` joins the
forward and the backward as a ``torch.autograd.Function``, which
``ops.wkv6`` takes when grad is on.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build
from repro_torch.kernels import cost
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import aligned_for_tma

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)
CHUNKED, SEQUENTIAL = "mma.sync chunked", "cuda-core sequential"
ENTRY = {CHUNKED: "wkv6_chunked_fwd", SEQUENTIAL: "wkv6_fwd"}
CHUNK = 16  # steps a chunk in csrc/wkv6_chunked.cu

launches = 0  # kernel launches since the last reset; the CPU path does not count
kernel_launches = {CHUNKED: 0, SEQUENTIAL: 0}  # the same, by kernel
# the backward's designs (``wkv6_bwd(..., kernel=)`` overrides the dtype's):
# bf16 a chunked scan on the tensor cores (csrc/wkv6_bwd_chunked.cu: two
# chains keep the state and its cotangent every CHUNK steps, then one block
# per chunk computes its gradients), f32 the CUDA-core kernel
# (csrc/wkv6_bwd.cu: a forward pass keeps the state every CHUNK steps, then
# two reverse-time scans over the state's rows and its columns; it takes
# bf16 too), so that f32 products stay true f32
BWD_CHUNKED, BWD_TWO_SCAN = "mma.sync chunked", "cuda-core two-scan"
BWD_ENTRY = {BWD_CHUNKED: "wkv6_bwd_chunked", BWD_TWO_SCAN: "wkv6_bwd"}
BWD_DESIGNS = {torch.bfloat16: BWD_CHUNKED, torch.float32: BWD_TWO_SCAN}
bwd_launches = 0  # backward kernel launches since the last reset
bwd_kernel_launches = {BWD_CHUNKED: 0, BWD_TWO_SCAN: 0}  # the same, by design


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
    B, S, H, D = r.shape
    if isinstance(r, FakeTensor):
        cost.record("wkv6_fwd", cost.wkv6_fwd(B, S, H, D, r.element_size()))
        return r.new_empty((B, S, H, D)), (
            r.new_empty((B, H, D, D), dtype=torch.float32) if state is None else state)
    if r.device.type == "cpu":
        out, s = ref.wkv6_ref(r, k, v, w, u, state)
        return out, (s if state is None else state.copy_(s))
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
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


def _chunk_a(rc: torch.Tensor, kc: torch.Tensor, wc: torch.Tensor,
             uf: torch.Tensor) -> torch.Tensor:
    """A of chunks (..., n, D) -> (..., n, n): A[t, s] = sum_i r_t,i k_s,i
    prod_{s < tau < t} w_tau,i for s < t, A[t, t] = sum_i r_t,i u_i k_t,i,
    0 above the diagonal; every decay a running product (no division)."""
    n = rc.shape[-2]
    A = rc.new_zeros(rc.shape[:-1] + (n,))
    A[..., range(n), range(n)] = (rc * uf * kc).sum(-1)
    q = kc.clone()  # q[s] = k_s prod_{s < tau < s + d} w_tau at lag d
    for d in range(1, n):
        A[..., range(d, n), range(n - d)] = (rc[..., d:, :] * q[..., :n - d, :]).sum(-1)
        q[..., :n - d, :] = q[..., :n - d, :] * wc[..., d:n, :]
    return A


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
        A = _chunk_a(rc, kc, wc, uf)
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


def wkv6_chunked_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                     u: torch.Tensor, state: Optional[torch.Tensor], do: torch.Tensor,
                     ds: Optional[torch.Tensor] = None, *, chunk: int = CHUNK,
                     split: bool = True, dtype: torch.dtype = torch.float32
                     ) -> tuple[torch.Tensor, ...]:
    """The chunked backward kernel's arithmetic (``csrc/wkv6_bwd_chunked.cu``)
    in plain PyTorch, used by the tests only; same arguments and results as
    ``ref.wkv6_bwd_ref``.  For one (b, h) and a chunk [b0, e) of n steps, t
    local, with S0 the state at b0 and Ge the state's cotangent at e:

      pre_t = prod_{tau<t} w_tau   suf_s = prod_{s<tau<n} w_tau
      Dec(s, t) = prod_{s<tau<t} w_tau;  A as the forward's (``_chunk_a``)
      dA = tril(dO v^T)   P = dO S0^T   Q = v Ge^T
      G_b0 = diag(pre_n) Ge + (r*pre)^T dO     (the cotangent chain)
      S_e  = diag(pre_n) S0 + (k*suf)^T v      (the state chain)
      dv   = A^T dO + (k*suf) Ge
      dr_t = pre_t P_t + Y_t,t + dA[t,t] u k_t,  Y_t,tau = sum_{s<tau} dA[t,s] k_s Dec(s,tau)
      dk_s = suf_s Q_s + Z_s,s + dA[s,s] u r_s,  Z_s,tau = sum_{t>tau} dA[t,s] r_t Dec(tau,t)
      du  += sum_t dA[t,t] r_t k_t
      dw_tau = pre_tau suf_tau rowsum(S0 * Ge) + pre_tau sum_{t>tau} Dec(tau,t) r_t P_t
             + suf_tau sum_{s<tau} Dec(s,tau) k_s Q_s + sum_{t>tau} r_t Dec(tau,t) Y_t,tau

    Y and Z run as running products (Y_t,tau+1 = w_tau Y_t,tau + dA[t,tau]
    k_tau, Z in reverse), so no term divides by w.  The kernel keeps S0 and
    Ge of every other chunk and rebuilds the rest with the same chunk
    update, which this function runs for every chunk.  With ``split`` the
    products take every operand that is not an input (k*suf, r*pre, S0, Ge,
    A) as a two-term bf16 split with f32 sums, as the kernel's mma.sync
    does; without it they are exact in ``dtype`` (f32, or f64)."""
    B, S, H, D = r.shape
    L = chunk
    nc = -(-S // L)

    def chunks(x, fill=0.0):  # (B, S, H, D) -> (B, H, nc, L, D), padded past S
        x = x.to(dtype).transpose(1, 2)
        pad = x.new_full((B, H, nc * L - S, D), fill)
        return torch.cat([x, pad], 2).reshape(B, H, nc, L, D)

    rc, kc, vc, dc = (chunks(x) for x in (r, k, v, do))
    wc = chunks(w, 1.0)  # w = 1 past S leaves every product unchanged
    uf = u.to(dtype)[None, :, None, None, :]
    hl = _hi_lo if split else (lambda x: (x, torch.zeros_like(x)))
    pre = torch.ones((B, H, nc, L + 1, D), dtype=dtype)
    for t in range(L):
        pre[..., t + 1, :] = pre[..., t, :] * wc[..., t, :]
    suf = torch.ones((B, H, nc, L, D), dtype=dtype)
    for s in range(L - 2, -1, -1):
        suf[..., s, :] = suf[..., s + 1, :] * wc[..., s + 1, :]
    pre_n, pre = pre[..., L, :, None], pre[..., :L, :]
    (rh, rl), (kh, kl) = hl(rc * pre), hl(kc * suf)
    # the two chains: the state at every chunk's start, the cotangent at its end
    st = (torch.zeros((B, H, D, D), dtype=dtype) if state is None else state.to(dtype))
    s0 = []
    for c in range(nc):
        s0.append(st)
        st = pre_n[:, :, c] * st + kh[:, :, c].mT @ vc[:, :, c] + kl[:, :, c].mT @ vc[:, :, c]
    g = torch.zeros((B, H, D, D), dtype=dtype) if ds is None else ds.to(dtype)
    ge = [g] * nc
    for c in range(nc - 1, -1, -1):
        ge[c] = g
        g = pre_n[:, :, c] * g + rh[:, :, c].mT @ dc[:, :, c] + rl[:, :, c].mT @ dc[:, :, c]
    s0, ge = torch.stack(s0, 2), torch.stack(ge, 2)  # (B, H, nc, D, D)
    (s0h, s0l), (geh, gel) = hl(s0), hl(ge)
    # every chunk's gradients from its S0 and Ge alone
    P = dc @ s0h.mT + dc @ s0l.mT  # P[t, i] = sum_j dO_t,j S0[i, j]
    Q = vc @ geh.mT + vc @ gel.mT
    dA = dc @ vc.mT  # [t, s]; only s <= t is read
    ah, al = hl(_chunk_a(rc, kc, wc, uf))
    dv = ah.mT @ dc + al.mT @ dc + kh @ geh + kh @ gel + kl @ geh
    diag = dA.diagonal(dim1=-2, dim2=-1)[..., None]
    Y = torch.zeros_like(rc)  # Y[t] = Y_t,tau while tau runs, Y_t,t after
    t4 = torch.zeros_like(rc)
    for tau in range(L - 1):
        dec = torch.cumprod(torch.cat([torch.ones_like(wc[..., :1, :]),
                                       wc[..., tau + 1:L - 1, :]], -2), -2)  # Dec(tau, t)
        t4[..., tau, :] = (dec * rc[..., tau + 1:, :] * Y[..., tau + 1:, :]).sum(-2)
        Y[..., tau + 1:, :] = (wc[..., tau:tau + 1, :] * Y[..., tau + 1:, :]
                               + dA[..., tau + 1:, tau, None] * kc[..., tau:tau + 1, :])
    Z = torch.zeros_like(rc)  # Z[s] = Z_s,tau while tau runs down, Z_s,s after
    for tau in range(L - 1, 0, -1):
        Z[..., :tau, :] = (wc[..., tau:tau + 1, :] * Z[..., :tau, :]
                           + dA[..., tau, :tau, None] * rc[..., tau:tau + 1, :])
    dr = pre * P + Y + diag * uf * kc
    dk = suf * Q + Z + diag * uf * rc
    x, y = rc * P, kc * Q
    r2, l3 = torch.zeros_like(rc), torch.zeros_like(rc)
    for tau in range(L - 2, -1, -1):  # sum_{t>tau} Dec(tau, t) x_t
        r2[..., tau, :] = x[..., tau + 1, :] + wc[..., tau + 1, :] * r2[..., tau + 1, :]
    for tau in range(1, L):  # sum_{s<tau} Dec(s, tau) y_s
        l3[..., tau, :] = y[..., tau - 1, :] + wc[..., tau - 1, :] * l3[..., tau - 1, :]
    csum = (s0 * ge).sum(-1)[..., None, :]
    dw = pre * suf * csum + pre * r2 + suf * l3 + t4
    du = (diag * rc * kc).sum((0, 2, 3))

    def unchunk(x, like):
        return x.reshape(B, H, nc * L, D)[:, :, :S].transpose(1, 2).to(like.dtype)

    return (unchunk(dr, r), unchunk(dk, k), unchunk(dv, v), unchunk(dw, w),
            du.float(), g.float())


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: Optional[torch.Tensor], do: torch.Tensor,
             ds: Optional[torch.Tensor] = None, *,
             kernel: Optional[str] = None) -> tuple[torch.Tensor, ...]:
    """The VJP of ``wkv6`` at (r, k, v, w, u, state) for the output's
    cotangent ``do`` (B, S, H, D) in r's dtype and the final state's ``ds``
    (B, H, D, D) f32 or None (zeros).  ``state`` is the initial state (f32
    or None for zeros), as it was before the forward updated it.  Returns
    (dr, dk, dv, dw in r's dtype, du (H, D) f32, the initial state's
    cotangent f32).  ``kernel`` (BWD_CHUNKED or BWD_TWO_SCAN) overrides
    ``BWD_DESIGNS`` on the card, to compare the two; the chunked design
    takes bf16 only."""
    global bwd_launches
    _check(r, k, v, w, u, state)
    if tuple(do.shape) != tuple(r.shape) or do.dtype != r.dtype or do.device != r.device:
        raise ValueError(f"do must be {r.dtype} {tuple(r.shape)} on {r.device}; got "
                         f"{do.dtype} {tuple(do.shape)} on {do.device}")
    B, S, H, D = r.shape
    _check_state("ds", ds, (B, H, D, D), r.device)
    kernel = kernel or BWD_DESIGNS[r.dtype]
    if kernel not in BWD_ENTRY:
        raise ValueError(f"unknown backward kernel {kernel!r}; one of {list(BWD_ENTRY)}")
    if kernel == BWD_CHUNKED and r.dtype != torch.bfloat16:
        raise ValueError(f"the chunked backward takes bf16; got {r.dtype}")
    if isinstance(r, FakeTensor):
        cost.record("wkv6_bwd", cost.wkv6_bwd(B, S, H, D, r.element_size(),
                                              with_state=state is not None))
        return (*(torch.empty_like(t) for t in (r, k, v, w)),
                r.new_empty((H, D), dtype=torch.float32),
                r.new_empty((B, H, D, D), dtype=torch.float32))
    if r.device.type == "cpu":
        return ref.wkv6_bwd_ref(r, k, v, w, u, state, do, ds)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    r, k, v, w, do = (t.contiguous() for t in (r, k, v, w, do))
    if kernel == BWD_CHUNKED:
        for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("do", do)):
            if not aligned_for_tma(t):  # its 16-byte copies
                raise ValueError(f"{name} must start on a 16-byte boundary for the chunked "
                                 f"backward (data_ptr % 16 = {t.data_ptr() % 16})")
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    du = torch.zeros((H, D), dtype=torch.float32, device=r.device)
    ds0 = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    if r.numel() == 0:
        return (dr, dk, dv, dw, du,
                ds0.zero_() if ds is None else ds0.copy_(ds))
    n_chunks = -(-S // CHUNK)
    u32 = u.to(torch.float32).contiguous()
    lib = _build.load()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        # scratch: f32 checkpoints, the state every CHUNK steps (the CUDA-core
        # design) or the state and its cotangent every 2 CHUNK steps (the
        # chunked design), and du's partial sums, per (b, h, chunk) or (b, h)
        if kernel == BWD_CHUNKED:
            n_ckpt = -(-n_chunks // 2)
            ck = torch.empty((2, B, H, n_ckpt, D, D), dtype=torch.float32, device=r.device)
            du_part = torch.empty((B, H, n_chunks, D), dtype=torch.float32, device=r.device)
            scratch = (ck[0].data_ptr(), ck[1].data_ptr(), du_part.data_ptr())
        else:
            ck = torch.empty((B, H, n_chunks, D, D), dtype=torch.float32, device=r.device)
            du_part = torch.empty((B, H, D), dtype=torch.float32, device=r.device)
            scratch = (ck.data_ptr(), du_part.data_ptr())
        err = getattr(lib, BWD_ENTRY[kernel])(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u32.data_ptr(),
            None if state is None else state.data_ptr(), do.data_ptr(),
            None if ds is None else ds.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            ds0.data_ptr(), *scratch, DTYPES[r.dtype], B, S, H, D, stream)
    _build.check(lib, err, f"{BWD_ENTRY[kernel]} launch")
    bwd_launches += 1
    bwd_kernel_launches[kernel] += 1
    return dr, dk, dv, dw, du, ds0


class WKV6(torch.autograd.Function):
    """Differentiable WKV-6: ``wkv6`` forward (a given state is updated in
    place, as serving does, and marked dirty) and ``wkv6_bwd`` backward.
    The forward keeps a copy of the initial state, which the backward reads
    after the in-place update has overwritten it."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        s0 = None if state is None else state.clone()
        out, s_out = wkv6(r, k, v, w, u, state)
        if state is not None:
            ctx.mark_dirty(state)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return out, s_out

    @staticmethod
    def backward(ctx, do, ds):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dr, dk, dv, dw, du, ds0 = wkv6_bwd(r, k, v, w, u, s0, do, ds.contiguous())
        return dr, dk, dv, dw, du.to(u.dtype), (None if s0 is None else ds0)
