"""Plain PyTorch versions of the oracles in ``repro.kernels.ref``: attention
(with the row log-sum-exp and the backward of ``repro.kernels.ops._flash``),
decode attention, the RWKV-6 WKV recurrence and the RG-LRU recurrence.

They are the CPU path of every kernel wrapper and the yardstick the CUDA
kernels are held against on the card.  They favour clarity over memory: the
full score matrix is materialized.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int, chunk: int) -> torch.Tensor:
    """(Sq, Sk) boolean mask. True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    if chunk > 0:
        m &= torch.div(q_pos[:, None], chunk, rounding_mode="floor") == \
            torch.div(k_pos[None, :], chunk, rounding_mode="floor")
    return m


def _scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool, window: int, chunk: int,
            softcap: float, q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 scores (B, KV, G, Sq, Sk), NEG_INF where the mask drops a pair,
    and the mask (Sq, Sk)."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    qf = q.float().reshape(B, Sq, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(D)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    m = _mask(q_pos, k_pos, causal=causal, window=window, chunk=chunk)
    return torch.where(m[None, None, None], s, torch.full_like(s, NEG_INF)), m


def attention_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, D)
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    B, Sq, H, D = q.shape
    s, m = _scores(q, k, causal=causal, window=window, chunk=chunk, softcap=softcap,
                   q_offset=q_offset)
    p = torch.softmax(s, dim=-1)
    # rows with no valid key -> zero out
    p = torch.where(m.any(-1)[None, None, None, :, None], p, torch.zeros_like(p))
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def attention_lse_ref(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``attention_ref``'s output and the row log-sum-exp (B, H, Sq) in f32,
    head h = kv * G + g, as ``ops._flash_fwd_impl`` forms it:
    m + log(max(l, 1e-20)), so -1e30 for a row with no valid key."""
    B, Sq, H, _ = q.shape
    s, mask = _scores(q, k, causal=causal, window=window, chunk=chunk, softcap=softcap)
    m = s.amax(-1)
    l = torch.where(mask[None, None, None], torch.exp(s - m[..., None]), 0.0).sum(-1)
    lse = m + torch.log(torch.clamp(l, min=1e-20))
    o = attention_ref(q, k, v, causal=causal, window=window, chunk=chunk, softcap=softcap)
    return o, lse.reshape(B, H, Sq)


def flash_bwd_ref(
    q: torch.Tensor,    # (B, Sq, H, D)
    k: torch.Tensor,    # (B, Sk, KV, D)
    v: torch.Tensor,
    o: torch.Tensor,    # (B, Sq, H, D)
    lse: torch.Tensor,  # (B, H, Sq) f32
    do: torch.Tensor,   # (B, Sq, H, D)
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 0,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The arithmetic of ``ops._flash_bwd_impl`` unblocked, in f32: P from
    (q, k, lse) under the mask, delta = rowsum(dO * O), dV = P^T dO,
    dS = P (dO V^T - delta) [(1 - tanh^2)] * scale, dQ = dS K, dK = dS^T Q,
    dK and dV summed over each kv head's G query heads.  Returns (dq, dk,
    dv) in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, KV, G, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    if softcap > 0:
        sc = torch.tanh(s / softcap)
        s = sc * softcap
    q_pos = torch.arange(Sq, device=q.device)
    m = _mask(q_pos, torch.arange(Sk, device=q.device), causal=causal, window=window,
              chunk=chunk)[None, None, None]
    lse_b = lse.float().reshape(B, KV, G, Sq)
    p = torch.where(m, torch.exp(s - lse_b[..., None]), 0.0)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", dof, o.float().reshape(B, Sq, KV, G, D))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta[..., None])
    if softcap > 0:
        ds = ds * (1.0 - torch.square(sc))
    ds = ds * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, Sq, H, D)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(
    q: torch.Tensor,         # (B, 1, H, D)
    k_cache: torch.Tensor,   # (B, L, KV, D)
    v_cache: torch.Tensor,   # (B, L, KV, D)
    slot_pos: torch.Tensor,  # (B, L) absolute position per slot, -1 = empty
    pos: torch.Tensor,       # (B,) current query position
    *,
    window: int = 0,
    chunk: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, _, H, D = q.shape
    _, L, KV, _ = k_cache.shape
    G = H // KV
    qf = q.float().reshape(B, KV, G, D)
    s = torch.einsum("bkgd,blkd->bkgl", qf, k_cache.float()) / math.sqrt(D)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window > 0:
        valid &= (pos[:, None] - slot_pos) < window
    if chunk > 0:
        valid &= torch.div(slot_pos, chunk, rounding_mode="floor") == \
            torch.div(pos[:, None], chunk, rounding_mode="floor")
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(-1)[:, None, None, None], p, torch.zeros_like(p))
    o = torch.einsum("bkgl,blkd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def wkv6_ref(
    r: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, H, D)
    v: torch.Tensor,  # (B, S, H, D)
    w: torch.Tensor,  # (B, S, H, D) per-step decay in (0, 1)
    u: torch.Tensor,  # (H, D) bonus for the current token
    state: torch.Tensor | None = None,  # (B, H, D, D) [key-dim x value-dim]
) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 (Finch) recurrence, exact sequential form, in f32.

    out_t = r_t . (S_t + diag(u) k_t^T v_t);  S_{t+1} = diag(w_t) S_t + k_t^T v_t

    Returns (out in r's dtype, final state in f32).
    """
    B, S, H, D = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, D, D)
        outs.append(torch.einsum("bhd,bhde->bhe", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    out = torch.stack(outs, 1) if outs else torch.zeros_like(rf)
    return out.to(r.dtype), s


def rglru_ref(
    x: torch.Tensor,      # (B, S, W) gated input (i_t * x_t)
    log_a: torch.Tensor,  # (B, S, W) log recurrence coefficient, <= 0
    h0: torch.Tensor | None = None,  # (B, W)
) -> tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU linear recurrence, exact sequential form, in f32.

    h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * x_t,  a_t = exp(log_a_t)

    Returns (h in x's dtype, final h in f32).
    """
    B, S, W = x.shape
    xf = x.float()
    laf = log_a.float()
    a = torch.exp(laf)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * laf), min=1e-12)) * xf
    h = (torch.zeros((B, W), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    out = torch.stack(hs, 1) if hs else torch.zeros_like(xf)
    return out.to(x.dtype), h
