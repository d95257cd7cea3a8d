"""Compute ops used by the model, following ``repro.kernels.ops``.

``flash_attention`` always goes to the kernel wrappers, at any mask, Sq, Sk
and q_offset (which take the plain versions only for CPU tensors): when grad
is enabled and q, k or v requires grad, through ``FlashAttention`` (forward
with the LSE, backward kernel); otherwise (serving, under
``inference_mode``) through the forward alone, which writes no LSE.  There
is no tiny-shape shortcut to the oracle, as the reference has for Sq * Sk
<= 2^20: every shape takes the kernel.
``decode_attention`` stays plain PyTorch, as the reference leaves it in jnp.
``wkv6`` and ``rglru`` always go to their kernel wrappers, with or without
a state, like ``flash_attention``: when grad is enabled and an input
requires grad, through ``WKV6`` or ``RGLRU`` (the forward kernel, and the
backward kernel in the backward pass), otherwise (serving) through the
forward wrapper alone.  ``causal_conv1d`` is plain PyTorch, as the reference
computes it in jnp outside any kernel.

On a mesh (inside ``parallel.axes.mesh_context``, with DTensor inputs) no
kernel ever gets a DTensor: each call goes through ``local_map`` (the
counterpart of ``shard_map``) with the placements the rules give -- batch
over ``act_batch``, heads over ``act_heads`` / ``act_kv_heads``, RG-LRU
channels over ``act_lru`` -- so each rank's kernel runs on its own shard.
Attention, WKV-6 and RG-LRU are independent per batch row and per head or
channel, so a sharded call is exact.  The gradient of an input that is
replicated over a mesh dim its partner is sharded over (k and v beside
head-sharded q, WKV-6's u beside batch-sharded r) is a per-rank partial
sum: it comes back ``Partial`` over that dim, and DTensor sums it.  Before
that, attention tries context parallelism (``_maybe_context_parallel``);
as in the reference's non-Pallas path, it is checked before the kernel
route.  ``embedding`` looks up each rank's own tokens the same way.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as kg
from repro_torch.kernels import wkv6 as k6
from repro_torch.parallel import axes as paxes

# calls that went through local_map on a mesh, by op (each launches its
# kernels on every rank's shards)
mapped = {"flash_attention": 0, "wkv6": 0, "rglru": 0}


def _on_mesh(*tensors: Optional[torch.Tensor]) -> bool:
    """Inside a mesh context, with at least one DTensor among the inputs."""
    return paxes.current_mesh() is not None and any(
        isinstance(t, DTensor) for t in tensors)


def _mapped(fn: Callable, tensors: tuple, in_pl: tuple, out_pl, lead: tuple):
    """``fn`` on each rank's shards of ``tensors`` (None passes through;
    plain tensors count as replicated), inputs redistributed to ``in_pl``,
    outputs placed as ``out_pl``.  An input's gradient is Partial over the
    mesh dims that ``lead`` shards and the input does not: there each rank
    holds a partial sum of it."""
    mesh = paxes.current_mesh()
    args, in_p, grad_p = [], [], []
    for t, pl in zip(tensors, in_pl):
        if t is None:
            args.append(None)
            in_p.append(None)
            grad_p.append(None)
            continue
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        args.append(t)
        in_p.append(pl)
        grad_p.append(tuple(Partial() if isinstance(p, Replicate) and not isinstance(l, Replicate)
                            else p for p, l in zip(pl, lead)))
    if all(isinstance(p, Placement) for p in out_pl):  # one output: a list, not a tuple
        out_pl = list(out_pl)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_p),
                     in_grad_placements=tuple(grad_p), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _own(state: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A rank's own copy of its shard of a state (a view of the DTensor's
    storage, which the kernels' autograd Functions may not update in place
    and return beside another output)."""
    return None if state is None else state.clone()


def _write_back(state: Optional[torch.Tensor], new: torch.Tensor) -> torch.Tensor:
    """Keep the local route's contract that a given state is updated in
    place: copy the kernel's final state into it, outside autograd."""
    if state is not None:
        with torch.no_grad():
            state.copy_(new if isinstance(state, DTensor) else new.full_tensor())
    return new


def _shard_index(pl: tuple, dim: int, mesh) -> int:
    """This rank's shard of tensor dim ``dim`` under ``pl`` (0 when no mesh
    dim shards it; mesh dims in order, the first outermost)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(i) + coord[i]
    return idx


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------
def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,
) -> torch.Tensor:
    if _on_mesh(q, k, v):
        mapped["flash_attention"] += 1
        cp = _maybe_context_parallel(q, k, v, causal=causal, window=window, chunk=chunk,
                                     softcap=softcap, q_offset=q_offset)
        if cp is not None:
            return cp
        return _flash_sharded(q, k, v, causal=causal, window=window, chunk=chunk,
                              softcap=softcap, q_offset=q_offset)
    return _flash_local(q, k, v, causal, window, chunk, softcap, q_offset)


def _flash_local(q, k, v, causal, window, chunk, softcap, q_offset):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return fa.FlashAttention.apply(q, k, v, causal, window, chunk, softcap, q_offset)
    return fa.flash_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                              softcap=softcap, q_offset=q_offset)


def _flash_sharded(q, k, v, *, causal, window, chunk, softcap, q_offset):
    """Batch- and head-sharded attention: each rank runs the kernel on its
    batch rows and query heads, with its heads' kv heads (a slice of k and v
    when they are not head-sharded themselves)."""
    mesh = paxes.current_mesh()
    q_pl = paxes.placements_for(q.shape, ("act_batch", "act_seq", "act_heads", None))
    kv_pl = paxes.placements_for(k.shape, ("act_batch", "act_seq", "act_kv_heads", None))
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    hq, hk = _shard_index(q_pl, 2, mesh), _shard_index(kv_pl, 2, mesh)

    def local(qs, ks, vs):
        Hl, KVl = qs.shape[2], ks.shape[2]
        # this rank's query heads' kv heads, as indices into its k and v
        idx = [(hq * Hl + j) // G - hk * KVl for j in range(Hl)]
        heads = sorted(set(idx))
        g = Hl // len(heads)
        if idx == [h for h in heads for _ in range(g)]:
            if len(heads) != KVl:
                ks, vs = ks[:, :, heads[0]:heads[-1] + 1], vs[:, :, heads[0]:heads[-1] + 1]
        else:  # the rank's heads straddle kv groups unevenly: one kv head each
            sel = torch.tensor(idx, device=ks.device)
            ks, vs = ks.index_select(2, sel), vs.index_select(2, sel)
        return _flash_local(qs, ks.contiguous(), vs.contiguous(), causal, window, chunk,
                            softcap, q_offset)

    return _mapped(local, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl, q_pl)


def _maybe_context_parallel(q, k, v, *, causal, window, chunk, softcap, q_offset):
    """Context-parallel flash attention over the ``model`` mesh dim.

    When the head count does not divide the model dim (24 heads on a 16-way
    dim, or MQA), head sharding would replicate the whole attention on every
    model rank.  Instead the q sequence is sharded over ``model`` (and the
    batch over ``pod`` / ``data``, as the reference does): each rank runs the
    flash kernel on its S / n query rows at q_offset = rank * S / n against
    the replicated K and V.  dK and dV come back Partial over ``model``, and
    DTensor sums them over the model group (the reference's psum of the
    replicated inputs' cotangents).  Applies with a ``model`` dim of n > 1,
    H % n != 0, no window, no chunk, Sq == Sk, q_offset 0 and Sq % n == 0;
    else returns None.
    """
    mesh = paxes.current_mesh()
    if mesh is None or mesh.mesh_dim_names is None or "model" not in mesh.mesh_dim_names:
        return None
    n = mesh.size(mesh.mesh_dim_names.index("model"))
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if n <= 1 or H % n == 0:  # heads shard fine: head-sharded attention is better
        return None
    if window or chunk or Sq != Sk or q_offset != 0 or Sq % n != 0:
        return None
    s_local = Sq // n
    rules = paxes.ShardingRules({"batch": ("pod", "data"), "seq": "model"})
    q_pl = paxes.placements(paxes.spec_for(q.shape, ("batch", "seq", None, None), mesh, rules),
                            mesh)
    kv_pl = paxes.placements(paxes.spec_for(k.shape, ("batch", None, None, None), mesh, rules),
                             mesh)

    def local(qs, ks, vs):
        off = mesh.get_local_rank("model") * s_local
        return _flash_local(qs, ks, vs, causal, 0, 0, softcap, off)

    return _mapped(local, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl, q_pl)


def embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On a mesh each rank looks up its own tokens' rows
    in the whole table through ``local_map``: DTensor's own index backward
    fails on sharded indices in some torch versions, and the table's
    gradient then comes back Partial over the tokens' sharded dims."""
    if _on_mesh(table, tokens):
        t_pl = tuple(tokens.placements) if isinstance(tokens, DTensor) else (
            (Replicate(),) * paxes.current_mesh().ndim)
        return _mapped(lambda t, i: t[i], (table, tokens),
                       ((Replicate(),) * len(t_pl), t_pl), t_pl, t_pl)
    return table[tokens]


def decode_attention(
    q: torch.Tensor,         # (B, 1, H, D)
    k_cache: torch.Tensor,   # (B, L, KV, D)
    v_cache: torch.Tensor,
    slot_pos: torch.Tensor,  # (B, L)
    pos: torch.Tensor,       # (B,)
    *,
    window: int = 0,
    chunk: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    if _on_mesh(q, k_cache, v_cache):
        return _decode_sharded(q, k_cache, v_cache, slot_pos, pos, window=window, chunk=chunk,
                               softcap=softcap)
    return ref.decode_attention_ref(q, k_cache, v_cache, slot_pos, pos,
                                    window=window, chunk=chunk, softcap=softcap)


def _decode_scores(q, k_cache, slot_pos, pos, *, window, chunk, softcap):
    """``ref.decode_attention_ref``'s f32 scores (B, KV, G, L) and its mask
    (B, 1, 1, L) over the slots given."""
    B, _, H, D = q.shape
    _, L, KV, _ = k_cache.shape
    qf = q.float().reshape(B, KV, H // KV, D)
    s = torch.einsum("bkgd,blkd->bkgl", qf, k_cache.float()) / math.sqrt(D)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window > 0:
        valid &= (pos[:, None] - slot_pos) < window
    if chunk > 0:
        valid &= torch.div(slot_pos, chunk, rounding_mode="floor") == \
            torch.div(pos[:, None], chunk, rounding_mode="floor")
    return s, valid[:, None, None, :]


def _decode_sharded(q, k_cache, v_cache, slot_pos, pos, *, window, chunk, softcap):
    """Decode attention over a cache sharded as the rules place it (batch,
    and the sequence over ``cache_seq``'s dims; kv heads where they are
    sharded): each rank scores its own slots, and the softmax is joined
    across the sequence's shards (flash decoding): the row maximum by a
    max-reduction, then the exponentials' sum and their product with V by
    a sum-reduction.  Exact up to the order of the sums."""
    from torch.distributed.tensor import distribute_tensor

    mesh = paxes.current_mesh()
    c_pl = paxes.placements_for(k_cache.shape,
                                ("cache_batch", "cache_seq", "act_kv_heads", None))
    on = {0: [], 1: [], 2: []}  # tensor dim of the cache -> mesh dims sharding it
    for i, p in enumerate(c_pl):
        if isinstance(p, Shard):
            on[p.dim].append(i)

    def pl(dims: dict, seq=None):
        """Placements sharding tensor dim d over the mesh dims that shard
        the cache's dim ``dims[d]``; the sequence's mesh dims get ``seq``."""
        out = [Replicate()] * mesh.ndim
        for d, cache_dim in dims.items():
            for i in on[cache_dim]:
                out[i] = Shard(d)
        if seq is not None:
            for i in on[1]:
                out[i] = seq
        return tuple(out)

    def dist(t, p):
        if isinstance(t, DTensor):
            return t
        return distribute_tensor(t, mesh, p, src_data_rank=None)

    q_pl, kv_pl = pl({0: 0, 2: 2}), tuple(c_pl)
    sp_pl, pos_pl = pl({0: 0, 1: 1}), pl({0: 0})
    stat_pl = pl({0: 0, 1: 2})  # (B, KV, G): batch and kv heads
    args = (q, k_cache, v_cache, dist(slot_pos, sp_pl), dist(pos, pos_pl))
    in_pl = (q_pl, kv_pl, kv_pl, sp_pl, pos_pl)
    mask = dict(window=window, chunk=chunk, softcap=softcap)

    def local_max(qs, ks, vs, sps, ps):
        s, valid = _decode_scores(qs, ks, sps, ps, **mask)
        return torch.where(valid, s, ref.NEG_INF).amax(-1)

    m = local_map(local_max, out_placements=list(pl({0: 0, 1: 2}, Partial("max"))),
                  in_placements=in_pl, device_mesh=mesh, redistribute_inputs=True)(*args)
    m = m.redistribute(mesh, stat_pl)

    def local_sums(qs, ks, vs, sps, ps, ms):
        s, valid = _decode_scores(qs, ks, sps, ps, **mask)
        p = torch.where(valid, torch.exp(s - ms[..., None]), 0.0)
        return p.sum(-1), torch.einsum("bkgl,blkd->bkgd", p, vs.float())

    l, o = local_map(local_sums, out_placements=(pl({0: 0, 1: 2}, Partial()),
                                                 pl({0: 0, 1: 2}, Partial())),
                     in_placements=in_pl + (stat_pl,), device_mesh=mesh,
                     redistribute_inputs=True)(*args, m)
    o_pl = pl({0: 0, 1: 2})

    def normed(ls, os_, qs):
        o_ = torch.where(ls[..., None] > 0, os_ / ls[..., None], 0.0)
        return o_.reshape(qs.shape).to(qs.dtype)

    return local_map(normed, out_placements=list(q_pl), in_placements=(stat_pl, o_pl, q_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        l.redistribute(mesh, stat_pl), o.redistribute(mesh, o_pl), q)


def wkv6(
    r: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # per-step decay in (0, 1)
    u: torch.Tensor,  # (H, D)
    state: Optional[torch.Tensor] = None,  # (B, H, D, D) f32, updated in place
) -> tuple[torch.Tensor, torch.Tensor]:
    if _on_mesh(r, k, v, w, u, state):
        mapped["wkv6"] += 1
        pl = paxes.placements_for(r.shape, ("act_batch", "act_seq", "act_heads", None))
        u_pl = paxes.placements_for(u.shape, ("act_heads", None))
        s_shape = (r.shape[0], r.shape[2], r.shape[3], r.shape[3])
        s_pl = paxes.placements_for(s_shape, ("act_batch", "act_heads", None, None))
        out, s_new = _mapped(lambda *a: _wkv6_local(*a[:5], _own(a[5])),
                             (r, k, v, w, u, state), (pl, pl, pl, pl, u_pl, s_pl), (pl, s_pl), pl)
        return out, _write_back(state, s_new)
    return _wkv6_local(r, k, v, w, u, state)


def _wkv6_local(r, k, v, w, u, state):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, state)):
        return k6.WKV6.apply(r, k, v, w, u, state)
    return k6.wkv6(r, k, v, w, u, state)


def rglru(
    x: torch.Tensor,      # (B, S, W) gated input
    log_a: torch.Tensor,  # (B, S, W) log recurrence coefficient (<= 0)
    h0: Optional[torch.Tensor] = None,  # (B, W) f32, updated in place
) -> tuple[torch.Tensor, torch.Tensor]:
    if _on_mesh(x, log_a, h0):
        mapped["rglru"] += 1
        pl = paxes.placements_for(x.shape, ("act_batch", "act_seq", "act_lru"))
        h_pl = paxes.placements_for((x.shape[0], x.shape[2]), ("act_batch", "act_lru"))
        out, h_new = _mapped(lambda x_, la, h: _rglru_local(x_, la, _own(h)),
                             (x, log_a, h0), (pl, pl, h_pl), (pl, h_pl), pl)
        return out, _write_back(h0, h_new)
    return _rglru_local(x, log_a, h0)


def _rglru_local(x, log_a, h0):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, log_a, h0)):
        return kg.RGLRU.apply(x, log_a, h0)
    return kg.rglru(x, log_a, h0)


def causal_conv1d(
    x: torch.Tensor,  # (B, S, W)
    w: torch.Tensor,  # (K, W) depthwise taps, w[-1] multiplies x_t
    state: Optional[torch.Tensor] = None,  # (B, K-1, W) trailing context
) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv in x's dtype, summed tap by tap in the
    reference's order.  Returns (out, the last K-1 inputs in x's dtype)."""
    B, S, W = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, W), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+K-1, W)
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S] * w[i]
    return out, xp[:, S:]
