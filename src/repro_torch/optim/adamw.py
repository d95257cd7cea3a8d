"""AdamW + global-norm clipping + schedules, and the 8-bit state variant
(after ``repro.optim.adamw``).

Parameters, gradients and moments are flat dicts keyed by flatten path; the
state mirrors the parameters.  Every scalar of the update (the schedule, the
bias corrections ``b ** step``, the clip scale) is computed in f32, as the
reference computes it, so both packages take the same step to the ulp.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


# the donated 8-bit update works through a quantized leaf SLICE_ELEMENTS
# at a time (whole blocks), and the global norm a large leaf, so that no
# temporary of either exceeds that many elements: 256 MiB in f32, where a
# whole (5120, 202048) leaf is 4.1 GB
SLICE_ELEMENTS = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict  # like params (f32), or {"q", "s"} entries in the 8-bit state
    v: dict


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in f32."""
    step_f = step.to(torch.float32)
    warm = torch.clamp(step_f / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step_f - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def init(params: dict) -> AdamWState:
    device = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        # zeros_like: on a mesh the moments are placed as their parameters
        m={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        v={k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()})


def global_norm(tree: dict) -> torch.Tensor:
    """The L2 norm over every leaf, in f32; a leaf of more than
    SLICE_ELEMENTS elements is squared and summed SLICE_ELEMENTS at a time
    (its whole square was a temporary as large as the leaf), but for a
    DTensor, whose sharded dims cannot be flattened."""
    total = torch.zeros((), dtype=torch.float32, device=next(iter(tree.values())).device)
    for x in tree.values():
        whole = x.numel() <= SLICE_ELEMENTS or isinstance(x, DTensor)  # a shard is local
        for part in (x,) if whole else x.reshape(-1).split(SLICE_ELEMENTS):
            total = total + torch.sum(torch.square(part.float()))
    return torch.sqrt(total)


def _clip_and_step(cfg: AdamWConfig, state: AdamWState, grads: dict):
    """(pre-clip norm, clip scale, new step, lr, b1c, b2c), all f32 but the step."""
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    step = state.step + 1
    step_f = step.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, step_f)
    b2c = 1.0 - torch.pow(cfg.b2, step_f)
    return gnorm, scale, step, schedule(cfg, step), b1c, b2c


@torch.no_grad()
def apply(cfg: AdamWConfig, params: dict, state: AdamWState, grads: dict, *,
          donate: bool = False):
    """One AdamW update. Returns (new_params, new_state, metrics); weight
    decay applies to every leaf, norms included, as in the reference.

    ``donate=True`` hands the params' and moments' storage to the update, as
    ``jax.jit``'s ``donate_argnums`` does: each leaf is updated in place
    (the dicts returned hold the same tensors) by the same operations in
    the same order, so to the same bits, and no second copy of the weights
    and moments is made (the caller must not read the old values)."""
    gnorm, scale, step, lr, b1c, b2c = _clip_and_step(cfg, state, grads)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = (state.m[k], state.v[k]) if donate else (state.m[k].clone(), state.v[k].clone())
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_(torch.square(g).mul_(1.0 - cfg.b2))
        del g
        # mhat / (sqrt(vhat) + eps) + weight_decay * p, times lr
        delta = m / b1c
        delta.div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float()).mul_(lr)
        if donate and p.dtype == torch.float32:
            new_p[k] = p.sub_(delta)
        else:
            new = (p.float() - delta).to(p.dtype)
            new_p[k] = p.copy_(new) if donate else new
        new_m[k], new_v[k] = m, v
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# 8-bit optimizer state (bitsandbytes-style blockwise quantization): m and v
# of every leaf of at least QUANT_MIN_SIZE elements as int8 with one f32
# scale a block of the last axis.
# ---------------------------------------------------------------------------
QUANT_MIN_SIZE = 4096  # leaves smaller than this stay f32


def _opt_block(last_dim: int) -> int:
    b = 256
    while last_dim % b:
        b //= 2
    return max(b, 1)


SCALE_FLOOR = 1e-12  # the least block scale (an all-zero block's)


def _q8(x: torch.Tensor) -> dict:
    blk = _opt_block(x.shape[-1])
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // blk, blk)
    s = torch.clamp(torch.amax(torch.abs(xb), dim=-1) / 127.0, min=SCALE_FLOOR)
    q = torch.clamp(torch.round(xb / s[..., None]), -127, 127).to(torch.int8)
    return {"q": q.reshape(x.shape), "s": s}


def _dq8(ent: dict) -> torch.Tensor:
    q, s = ent["q"], ent["s"]
    blk = q.shape[-1] // s.shape[-1]
    qb = q.reshape(*q.shape[:-1], q.shape[-1] // blk, blk)
    return (qb.to(torch.float32) * s[..., None]).reshape(q.shape)


def _quantizable(p: torch.Tensor) -> bool:
    return p.numel() >= QUANT_MIN_SIZE and p.dim() >= 1


def _scale_shape(shape) -> tuple:
    return tuple(shape[:-1]) + (shape[-1] // _opt_block(shape[-1]),)


def _splits_last(placement, ndim: int) -> bool:
    return isinstance(placement, Shard) and placement.dim % ndim == ndim - 1


def scale_placements(shape, placements, mesh) -> tuple:
    """The block scales' placements for a leaf of ``shape`` placed as
    ``placements`` on ``mesh``, as ``launch/specs.py`` (the reference's
    ``_opt_moment_shardings``) places them: the leaf's, except that a mesh
    dim splitting the last axis stays only while it (times those kept
    before it, in mesh order) divides the number of blocks; the others
    replicate the scales."""
    n_blocks = _scale_shape(shape)[-1]
    out, prod = list(placements), 1
    for i, pl in enumerate(placements):
        if _splits_last(pl, len(shape)):
            if n_blocks % (prod * mesh.size(i)) == 0:
                prod *= mesh.size(i)
            else:
                out[i] = Replicate()
    return tuple(out)


def _from_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _extent(shape, mesh, placements) -> tuple[list, list]:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` placed evenly as ``placements``: a dim split over several
    mesh dims is split by them in mesh order, as DTensor splits it.  Plain
    integers (DTensor's own helper makes tensors, which a FakeTensorMode
    cannot read back)."""
    local, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d, n = pl.dim % len(shape), mesh.size(i)
            if local[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split evenly {n} ways")
            local[d] //= n
            offset[d] += coord[i] * local[d]
    return local, offset


def init_8bit(params: dict) -> AdamWState:
    """Zero moments: int8 codes and f32 block scales for a leaf of at least
    QUANT_MIN_SIZE elements, else f32. On a mesh (DTensor parameters) each
    rank makes only its own shards: the codes and an f32 moment placed as
    their parameter, the scales as ``scale_placements`` says."""
    def z(p: torch.Tensor) -> Any:
        if not isinstance(p, DTensor):
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return _q8(zeros) if _quantizable(p) else zeros
        if not _quantizable(p):
            return torch.zeros_like(p, dtype=torch.float32)
        mesh, shape = p.device_mesh, _scale_shape(p.shape)
        pl = scale_placements(p.shape, p.placements, mesh)
        s = torch.full(_extent(shape, mesh, pl)[0], SCALE_FLOOR, dtype=torch.float32,
                       device=p.to_local().device)
        return {"q": torch.zeros_like(p, dtype=torch.int8), "s": _from_local(s, mesh, pl, shape)}

    device = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m={k: z(p) for k, p in params.items()},
                      v={k: z(p) for k, p in params.items()})


def _update_8bit(cfg: AdamWConfig, p, g, m, v, scale, lr, b1c, b2c, q8=_q8, dq8=_dq8):
    """One leaf's (or slice's) 8-bit AdamW update: (new p, new m, new v),
    the moments as ``q8`` entries where ``m`` and ``v`` are."""
    quant = isinstance(m, dict)
    m = dq8(m) if quant else m
    v = dq8(v) if quant else v
    g = g.float() * scale
    m_n = cfg.b1 * m + (1.0 - cfg.b1) * g
    v_n = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
    delta = (m_n / b1c) / (torch.sqrt(v_n / b2c) + cfg.eps) \
        + cfg.weight_decay * p.float()
    new_p = (p.float() - lr * delta).to(p.dtype)
    return new_p, (q8(m_n) if quant else m_n), (q8(v_n) if quant else v_n)


def _block_slices(p: torch.Tensor, g: torch.Tensor, m: Any, v: Any):
    """(p, g, m, v) of one leaf in slices of whole quantization blocks, each
    a view of the leaf's storage: the leaf as (blocks, block) rows, its
    scales as (blocks, 1), at most SLICE_ELEMENTS elements a slice.  The
    blocks lie along the last axis, so every block stays whole and
    ``_q8`` of a slice finds the leaf's own block size.  An f32 moment (a
    leaf under QUANT_MIN_SIZE) is one slice."""
    if not isinstance(m, dict):
        yield p, g, m, v
        return
    blk = _opt_block(p.shape[-1])
    rows = max(SLICE_ELEMENTS // blk, 1)
    p2, g2 = p.view(-1, blk), g.reshape(-1, blk)
    m2 = {"q": m["q"].view(-1, blk), "s": m["s"].view(-1, 1)}
    v2 = {"q": v["q"].view(-1, blk), "s": v["s"].view(-1, 1)}
    for i in range(0, p2.shape[0], rows):
        cut = slice(i, i + rows)
        yield (p2[cut], g2[cut], {k: t[cut] for k, t in m2.items()},
               {k: t[cut] for k, t in v2.items()})


def _write(dst: Any, src: Any) -> None:
    """``src`` (a tensor or a ``_q8`` entry) into ``dst``'s storage."""
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)


def _update_local(cfg, p, g, m, v, scalars, donate: bool, q8=_q8, dq8=_dq8):
    """The update of plain tensors: out of place, or (``donate``) written
    into them a slice of whole blocks at a time; returns (p, m, v)."""
    if not donate:
        return _update_8bit(cfg, p, g, m, v, *scalars, q8=q8, dq8=dq8)
    # a spanning codec's blocks are the global ones: it takes the whole shard
    for ps, gs, ms, vs in _block_slices(p, g, m, v) if q8 is _q8 else [(p, g, m, v)]:
        for dst, src in zip((ps, ms, vs), _update_8bit(cfg, ps, gs, ms, vs, *scalars, q8=q8,
                                                       dq8=dq8)):
            _write(dst, src)
    return p, m, v


def _locals(x: Any) -> Any:
    return {k: t.to_local() for k, t in x.items()} if isinstance(x, dict) else x.to_local()


def _spanning_codec(p: DTensor, s_pl: tuple):
    """(q8, dq8) of one rank's shard of a leaf whose quantization blocks
    span ranks (its shard of the last axis is not whole blocks): the
    blocks stay those of the global last axis.  Dequantizing takes each
    element's scale from the scales of the shard's rows, which the state
    holds with the last axis whole or sharded over fewer dims (gathered
    then: a few bytes a block).  Quantizing takes each block's absmax over
    the ranks that split the last axis: every rank's maxima of the pieces
    of blocks it holds (0 for the others), all-reduced by max over those
    mesh dims, one f32 a block (1 / blk of the leaf, where gathering the
    int8 codes would move the leaf); the codes are then local, and each
    rank keeps its shard of the scales."""
    mesh, shape, nd = p.device_mesh, tuple(p.shape), p.ndim
    blk = _opt_block(shape[-1])
    s_shape = _scale_shape(shape)
    local, offset = _extent(shape, mesh, p.placements)
    o, n = offset[-1], local[-1]
    b0, b1 = o // blk, (o + n - 1) // blk + 1  # the blocks this shard touches
    dev = p.to_local().device
    idx = torch.arange(o, o + n, device=dev) // blk - b0  # each element's block
    rows_pl = tuple(Replicate() if _splits_last(q, nd) else q for q in p.placements)
    part_pl = tuple(Partial("max") if _splits_last(q, nd) else q for q in p.placements)

    def rows(s: torch.Tensor) -> torch.Tensor:
        """The scales of the blocks the shard touches, for its rows."""
        if tuple(s_pl) != rows_pl:
            s = _from_local(s, mesh, s_pl, s_shape).redistribute(mesh, rows_pl).to_local()
        return s[..., b0:b1]

    def dq8(ent: dict) -> torch.Tensor:
        return ent["q"].to(torch.float32) * rows(ent["s"]).index_select(-1, idx)

    def q8(x: torch.Tensor) -> dict:
        a = F.pad(torch.abs(x), (o - b0 * blk, b1 * blk - o - n))  # zeros: not above any |x|
        part = torch.zeros(*x.shape[:-1], s_shape[-1], dtype=torch.float32, device=dev)
        part[..., b0:b1] = torch.amax(a.reshape(*x.shape[:-1], b1 - b0, blk), dim=-1)
        amax = _from_local(part, mesh, part_pl, s_shape).redistribute(mesh, rows_pl)
        s = torch.clamp(amax.to_local() / 127.0, min=SCALE_FLOOR)
        q = torch.clamp(torch.round(x / s[..., b0:b1].index_select(-1, idx)), -127, 127)
        if tuple(s_pl) != rows_pl:
            s = _from_local(s, mesh, rows_pl, s_shape).redistribute(mesh, s_pl).to_local()
        return {"q": q.to(torch.int8), "s": s}

    return q8, dq8


# DTensor leaves updated since the last reset, by path (``_update_sharded``)
sharded_updates = {"local": 0, "spanning": 0}


def _update_sharded(cfg, p: DTensor, g, m, v, scalars, donate: bool):
    """One DTensor leaf's update on each rank's shards, its blocks those of
    the global last axis.  Where every shard of the last axis holds whole
    blocks (the leaf's last axis unsplit, or split into multiples of the
    block), or the moments are f32, the update is the unsharded one on the
    local shards, with no communication; where a block spans ranks (e.g.
    qwen3-0.6b's (151936, 1024) embedding, its last axis split 16 ways into
    64 elements, a quarter of a block), the shards go through
    ``_spanning_codec``.  Returns DTensors placed as p, m and v are (the
    same ones under ``donate``)."""
    if not isinstance(g, DTensor):
        raise TypeError("a DTensor parameter needs a DTensor gradient")
    mesh = p.device_mesh
    if tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(mesh, p.placements)
    scalars = tuple(x.full_tensor() if isinstance(x, DTensor) else x for x in scalars)
    pl, gl, ml, vl = p.to_local(), g.to_local(), _locals(m), _locals(v)
    quant = isinstance(m, dict)
    blk = _opt_block(p.shape[-1])
    codec = {}
    if quant and pl.shape[-1] % blk:
        q8, dq8 = _spanning_codec(p, tuple(m["s"].placements))
        codec = {"q8": q8, "dq8": dq8}
    sharded_updates["spanning" if codec else "local"] += 1
    out = _update_local(cfg, pl, gl, ml, vl, scalars, donate, **codec)
    if donate:
        return p, m, v

    def like(local, ref):
        if isinstance(ref, dict):
            return {k: like(local[k], ref[k]) for k in ref}
        return _from_local(local, mesh, ref.placements, ref.shape)

    return like(out[0], p), like(out[1], m), like(out[2], v)


@torch.no_grad()
def apply_8bit(cfg: AdamWConfig, params: dict, state: AdamWState, grads: dict, *,
               donate: bool = False):
    """AdamW with int8-quantized m/v (dequant -> update -> requant).

    ``donate=True`` writes the new params, the moments' int8 codes and f32
    scales (and the f32 moments of leaves under QUANT_MIN_SIZE) into the
    tensors it was given, as ``apply``'s ``donate`` does, a slice of whole
    blocks at a time (``_block_slices``): the same operations in the same
    order, so the same bits, with no temporary over SLICE_ELEMENTS.  On a
    mesh (DTensor leaves) each rank updates its own shards
    (``_update_sharded``), the blocks those of the global last axis, and
    the state keeps ``init_8bit``'s placements."""
    gnorm, scale, step, lr, b1c, b2c = _clip_and_step(cfg, state, grads)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        update = _update_sharded if isinstance(p, DTensor) else _update_local
        new_p[k], new_m[k], new_v[k] = update(cfg, p, grads[k], state.m[k], state.v[k],
                                              (scale, lr, b1c, b2c), donate)
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}
