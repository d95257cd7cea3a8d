"""Transformer building blocks: norms, RoPE, attention, FFN, MoE (after
``repro.models.layers``).

Functions take plain tensors, or DTensors on a mesh; parameters come in as
dicts shaped as ``attention_defs`` / ``ffn_defs`` name them.  ``constrain``
stands where the reference constrains an activation's sharding (an
identity outside a mesh context), and also before each projection's
matmul, where XLA gathers the sequence-parallel residual stream by itself
and DTensor must be told (it does not flatten a sharded sequence into the
matmul's rows).  Projections are written as
matmuls over flattened head dims so q / k / v come out contiguous in the
(B, S, H, D) layout the attention kernel reads.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ATTN_KINDS, ArchConfig, MoESpec
from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef
from repro_torch.parallel.axes import constrain, constrain_view


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (S,). Split-halves rotation."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[..., None] * freqs  # (S, half)
    cos = torch.cos(ang)[..., None, :]  # (S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def attention_defs(cfg: ArchConfig, cross: bool = False) -> dict:
    """A layer's attention weights; a cross-attention layer has no q / k
    norm."""
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    defs = {
        "wq": ParamDef((d, H, Dh), ("embed", "q_heads", "head_dim")),
        "wk": ParamDef((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, KV, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, Dh, d), ("q_heads", "head_dim", "embed")),
    }
    if cfg.qk_norm and not cross:
        defs["q_norm"] = ParamDef((Dh,), ("head_dim",), init="ones")
        defs["k_norm"] = ParamDef((Dh,), ("head_dim",), init="ones")
    return defs


def _heads_proj(x: torch.Tensor, w: torch.Tensor, heads: str) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul, the heads placed as the
    logical axis ``heads``; the result is contiguous."""
    d, h, k = w.shape
    x = constrain(x, "act_batch", "act_seq", None)
    return constrain_view(x @ w.to(x.dtype).reshape(d, h * k), (*x.shape[:-1], h, k),
                          "act_batch", "act_seq", heads, None)


def _out_proj(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = w.shape
    o = constrain_view(o.contiguous(), (*o.shape[:-2], h * k),
                       "act_batch", "act_seq", "act_heads", None)
    return o @ w.to(o.dtype).reshape(h * k, d)


def _project_qkv(p: dict, xq: torch.Tensor, xkv: torch.Tensor, cfg: ArchConfig,
                 positions: Optional[torch.Tensor]):
    """q from ``xq``, k and v from ``xkv``; RoPE at ``positions`` unless it
    is None (cross-attention)."""
    q = _heads_proj(xq, p["wq"], "act_heads")
    k = _heads_proj(xkv, p["wk"], "act_kv_heads")
    v = _heads_proj(xkv, p["wv"], "act_kv_heads")
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, "act_batch", "act_seq", "act_heads", None)
    k = constrain(k, "act_batch", "act_seq", "act_kv_heads", None)
    v = constrain(v, "act_batch", "act_seq", "act_kv_heads", None)
    return q, k, v


class _Sites(threading.local):
    attn_out: bool = False


# where the running code is, for a remat policy: ``attn_out`` is set while
# self-attention's output projection runs (the tensor the reference tags
# "attn_out"); the recompute sets it again where it runs the layer again
SITES = _Sites()


@contextlib.contextmanager
def attn_out_site():
    SITES.attn_out = True
    try:
        yield
    finally:
        SITES.attn_out = False


def _mask(cfg: ArchConfig, kind: str) -> tuple[int, int]:
    """(window, chunk) of a ``kind`` layer, 0 = unbounded: ``cfg.window`` is
    a local layer's sliding window and a chunked layer's chunk."""
    if kind not in ATTN_KINDS:
        raise ValueError(f"{kind!r} is not an attention layer kind")
    return (cfg.window if kind == "local" else 0,
            cfg.window if kind == "chunked" else 0)


def self_attention(
    p: dict,
    x: torch.Tensor,  # (B, S, d) pre-normed input
    cfg: ArchConfig,
    kind: str,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns (attn output, (k, v)) — k/v reused for prefill cache writes."""
    window, chunk = _mask(cfg, kind)
    q, k, v = _project_qkv(p, x, x, cfg, positions)
    o = ops.flash_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                            softcap=cfg.attn_logit_softcap)
    o = constrain(o, "act_batch", "act_seq", "act_heads", None)
    with attn_out_site():
        out = _out_proj(o, p["wo"])
    return constrain(out, "act_batch", "act_seq", None), (k, v)


def cross_attention(
    p: dict,
    x: torch.Tensor,        # (B, S, d) pre-normed decoder stream
    enc_out: torch.Tensor,  # (B, Se, d) encoder output
    cfg: ArchConfig,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Decoder-to-encoder attention: no RoPE, no mask, no softcap (as the
    reference calls it), any Se.  Returns (output, (k, v)), k / v the
    encoder's, which the prefill caches."""
    q, k, v = _project_qkv(p, x, enc_out, cfg, None)
    o = ops.flash_attention(q, k, v, causal=False)
    return constrain(_out_proj(o, p["wo"]), "act_batch", "act_seq", None), (k, v)


def decode_cross_attention(
    p: dict,
    x: torch.Tensor,   # (B, 1, d)
    xk: torch.Tensor,  # (B, Se, KV, Dh) cached encoder keys
    xv: torch.Tensor,
    cfg: ArchConfig,
) -> torch.Tensor:
    """One token's cross-attention over the cached encoder keys and values,
    the reference's jnp: ``ops.decode_attention`` with every encoder slot
    valid (scores and softmax in f32, the output in x's dtype), which on a
    mesh joins the softmax across the cache's sequence shards."""
    B, Se = x.shape[0], xk.shape[1]
    q = _heads_proj(x, p["wq"], "act_heads")  # (B, 1, H, Dh)
    slots = torch.arange(Se, device=x.device)[None].expand(B, Se)
    o = ops.decode_attention(q, xk, xv, slots,
                             torch.full((B,), Se, dtype=torch.long, device=x.device))
    return _out_proj(o, p["wo"])


def decode_self_attention(
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    cfg: ArchConfig,
    kind: str,
    k_cache: torch.Tensor,  # (B, L, KV, Dh)
    v_cache: torch.Tensor,
    pos: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention; returns (out, k_cache, v_cache).

    Unlike the reference, the caches are updated in place (the new key and
    value go to ring slot ``pos % L``), which saves a copy of each cache per
    layer and step.  Like the reference, a local layer takes slot ``i`` to
    hold position ``pos - ((pos - i) % L)``; that is true of a prefill cache
    only when the prompt length is a multiple of L (the prefill keeps the
    last L keys in linear order), and the port keeps the reference's
    semantics.  A chunked layer's ring follows the local layer's rule.
    """
    window, chunk = _mask(cfg, kind)
    B = x.shape[0]
    L = k_cache.shape[1]
    positions = torch.tensor([pos], device=x.device)
    q, k, v = _project_qkv(p, x, x, cfg, positions)
    slot = pos % L  # ring slot (== pos for a full-length global cache)
    idx = torch.arange(L, device=x.device)
    if isinstance(k_cache, DTensor):
        # a sequence-sharded cache: DTensor cannot write one slot in place,
        # so the slot is selected and the cache rewritten in its layout
        hit = (idx == slot)[None, :, None, None]
        k_cache.copy_(torch.where(hit, k.to(k_cache.dtype), k_cache))
        v_cache.copy_(torch.where(hit, v.to(v_cache.dtype), v_cache))
    else:
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    # absolute position the reference assigns to each slot of the ring
    if kind == "global":
        slot_pos = torch.where(idx <= pos, idx, torch.full_like(idx, -1))
    else:
        cand = pos - torch.remainder(pos - idx, L)
        slot_pos = torch.where(cand >= 0, cand, torch.full_like(cand, -1))
    slot_pos = slot_pos[None].expand(B, L)
    o = ops.decode_attention(
        q, k_cache, v_cache, slot_pos,
        torch.full((B,), pos, dtype=torch.long, device=x.device),
        window=window, chunk=chunk, softcap=cfg.attn_logit_softcap)
    return _out_proj(o, p["wo"]), k_cache, v_cache


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU or classic MLP)
# ---------------------------------------------------------------------------
def ffn_defs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    defs = {
        "w_up": ParamDef((d, f), ("embed", "ff")),
        "w_down": ParamDef((f, d), ("ff", "embed")),
    }
    if cfg.ffn_gated:
        defs["w_gate"] = ParamDef((d, f), ("embed", "ff"))
    return defs


def ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    x = constrain(x, "act_batch", "act_seq", None)
    u = x @ p["w_up"].to(dt)
    if "w_gate" in p:  # SwiGLU
        h = F.silu(x @ p["w_gate"].to(dt)) * u
    else:  # classic MLP; jax.nn.gelu defaults to the tanh form
        h = F.gelu(u, approximate="tanh")
    h = constrain(h, "act_batch", "act_seq", "act_ff")
    return constrain(h @ p["w_down"].to(dt), "act_batch", "act_seq", None)


# ---------------------------------------------------------------------------
# Mixture of Experts (the reference's t5x-style groups with a capacity per
# group; dispatch and combine by index instead of one-hot products)
# ---------------------------------------------------------------------------
def moe_defs(cfg: ArchConfig) -> dict:
    assert cfg.moe is not None
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    defs = {
        "router": ParamDef((d, E), ("embed", "experts"), init_scale=0.1),
        "w_gate": ParamDef((E, d, f), ("experts", "embed", "ff")),
        "w_up": ParamDef((E, d, f), ("experts", "embed", "ff")),
        "w_down": ParamDef((E, f, d), ("experts", "ff", "embed")),
    }
    if cfg.moe.shared_expert:
        defs["shared"] = ffn_defs(cfg)
    return defs


def _capacity(spec: MoESpec, group: int) -> int:
    """Slots an expert has in a group of ``group`` tokens: a multiple of 4,
    at least 4."""
    c = math.ceil(group * spec.top_k * spec.capacity_factor / spec.n_experts)
    return max(4, math.ceil(c / 4) * 4)


def top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's k experts by probability, highest first: a stable
    descending sort puts equal probabilities in expert order, as
    ``lax.top_k`` does."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


# moe_ffn's calls on a mesh, by route: "per_rank" where each rank routes
# its own groups, "whole_batch" where a group would straddle a batch shard
# (every rank then routes the whole batch)
routes = {"per_rank": 0, "whole_batch": 0}


def moe_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """Routed expert FFN, the reference's function.  Returns (output, aux).

    The B*S tokens fall into groups of G, the largest divisor of B*S not
    above ``group_size``.  Each token picks its top-K experts by router
    probability (ties go to the lower expert, as ``lax.top_k`` gives them),
    its gates renormalised over the K.  An expert takes C slots a group, in
    the order of the group's (token, k) slots; later ones are dropped.

    Instead of the reference's one-hot dispatch and combine products, an
    integer table gives each (expert, group, slot) its token row (a zero row
    when empty), the rows are gathered into an (E, groups * C, d) buffer, the
    experts run as batched matmuls over E, and each token gathers its K
    outputs and sums them over k in order in f32, weighted by its gates
    rounded to x's dtype as the reference rounds them.  No float is summed by
    a scatter, so the result does not depend on the order of the card's
    threads.

    On a mesh (a DTensor ``x``) the groups inherit the token sharding, as
    the reference's do: where each batch shard holds whole groups, each
    rank routes, gathers and combines its own tokens' groups (local tensors:
    DTensor places no sort or integer scatter), the expert buffer is placed
    as the batch shards' groups, the experts' batched matmuls run on their
    sharded weights as DTensor ops, and the aux means are averaged over the
    batch shards.  The groups are the whole-batch ones in the same order, so
    the output is the same.  Where a group would straddle a shard (a small
    B*S, decode) every rank routes the whole batch instead (``routes``
    counts the two).
    """
    spec = cfg.moe
    assert spec is not None
    B, S, d = x.shape
    E, K = spec.n_experts, spec.top_k
    T = B * S
    G = min(spec.group_size, T)
    while T % G:  # largest divisor of T not exceeding group_size
        G -= 1
    ng = T // G
    C = _capacity(spec, G)
    dt = x.dtype
    # dispatch sees whole groups: the sequence unsharded (the reference's
    # dispatch and combine constraints have no tensor here to stand on)
    x = constrain(x, "act_batch", "act_seq", None)
    mesh = x.device_mesh if isinstance(x, DTensor) else None
    n = 1  # batch shards, each routing its own groups
    rep = own = rows = summed = None
    if mesh is not None:
        rep = (Replicate(),) * mesh.ndim
        n = math.prod(mesh.size(i) for i, pl in enumerate(x.placements) if isinstance(pl, Shard))
        if (T // n) % G:
            n = 1
        routes["per_rank" if n > 1 else "whole_batch"] += 1
        own = tuple(x.placements) if n > 1 else rep  # the tokens a rank routes
        rows = tuple(Shard(1) if isinstance(pl, Shard) else pl for pl in own)  # (E, groups*C, d)
        summed = tuple(Partial() if isinstance(pl, Shard) else pl for pl in own)

    def local(t, pl, grad_pl=None):  # a rank's part of a DTensor under pl
        return t if mesh is None else t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    def placed(t, pl):  # a rank's part as a DTensor under pl
        return t if mesh is None else DTensor.from_local(t, mesh, pl, run_check=False)

    def joined(v):  # a mean over a rank's groups -> over all of them
        if mesh is None:
            return v
        return placed(v / n, summed).redistribute(mesh, rep) if n > 1 else placed(v, rep)

    T, ng = T // n, ng // n  # from here on, a rank's own
    xf = local(x, own).reshape(T, d)
    # the router's gradient from a rank's own tokens: a partial sum
    logits = (xf.float() @ local(p["router"], rep, summed).float()).view(ng, G, E)
    probs = torch.softmax(logits, dim=-1)
    idx = top_k(probs.detach(), K)
    gates = probs.gather(-1, idx)  # (ng, G, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # a slot's place in its expert's queue: the running count over the
    # group's (token, k) slots, token-major and k-minor
    onehot = F.one_hot(idx, E)  # (ng, G, K, E)
    pos = onehot.view(ng, G * K, E).cumsum(1).view(ng, G, K, E).gather(-1, idx[..., None])
    pos = pos[..., 0] - 1
    keep = pos < C
    # each kept slot's row (expert, group, place) of the expert buffer; the
    # dropped ones point one past its end, at a zero row
    dev = xf.device
    n_rows = E * ng * C
    group = torch.arange(ng, device=dev).view(ng, 1, 1)
    row = torch.where(keep, (idx * ng + group) * C + pos, n_rows)
    token = (group * G + torch.arange(G, device=dev).view(1, G, 1)).expand(ng, G, K)
    table = torch.full((n_rows + 1,), T, dtype=torch.long, device=dev)
    table[row.reshape(-1)] = token.reshape(-1)  # kept rows are distinct

    x0 = torch.cat([xf, xf.new_zeros(1, d)])
    xin = placed(x0.index_select(0, table[:n_rows]).view(E, ng * C, d), rows)
    h = F.silu(torch.bmm(xin, p["w_gate"].to(dt))) * torch.bmm(xin, p["w_up"].to(dt))
    eo = local(torch.bmm(h, p["w_down"].to(dt)), rows).view(n_rows, d)
    eo = torch.cat([eo, eo.new_zeros(1, d)])
    row = row.view(T, K)
    w = torch.where(keep, gates, 0.0).to(dt).float().view(T, K)
    out = eo.index_select(0, row[:, 0]).float() * w[:, :1]
    for k in range(1, K):
        out = out + eo.index_select(0, row[:, k]).float() * w[:, k:k + 1]
    out = constrain(placed(out.to(dt).view(B // n, S, d), own), "act_batch", "act_seq", None)

    if "shared" in p:
        out = out + ffn(p["shared"], x)

    # aux losses (Switch-style load balance + router z-loss)
    me = probs.mean(dim=1)  # (ng, E) mean router probability
    ce = onehot.sum(2).float().mean(dim=1)  # (ng, E) fraction routed, before capacity
    lb_loss = (me * ce).sum(-1).mean() * E * spec.load_balance_loss
    z = torch.logsumexp(logits, dim=-1)
    z_loss = (z ** 2).mean() * spec.router_z_loss
    dropped = 1.0 - keep.sum() / (ng * G * K)
    aux = {"moe_lb_loss": joined(lb_loss), "moe_z_loss": joined(z_loss),
           "moe_dropped_frac": joined(dropped)}
    return out, aux
