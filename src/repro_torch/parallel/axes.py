"""Logical-axis sharding rules (after ``repro.parallel.axes``).

Every parameter and activation is annotated with *logical* axis names.  A
:class:`ShardingRules` table maps logical names to physical mesh dims;
swapping the table re-shards the whole model without touching model code.

Physical mesh dims (see ``repro_torch.launch.mesh``):
  * ``pod``   -- outer data-parallel dim crossing the pod boundary (slowest);
  * ``data``  -- intra-pod data-parallel / FSDP dim;
  * ``model`` -- tensor-parallel dim.

A spec (:class:`Spec`) has one entry per tensor dim -- None, a mesh dim
name, or a tuple of names -- as the reference's ``PartitionSpec``, and
:func:`placements` turns it into one DTensor placement per mesh dim.
DTensor splits a tensor dim that several mesh dims shard in mesh order, so
a tuple entry must list its names in mesh order (``("pod", "data")``); one
out of order raises.

Model code calls :func:`constrain` on activations with logical names: on a
DTensor inside :func:`mesh_context` it redistributes to the rules'
placements (the reference's ``with_sharding_constraint``); outside a
context, or on a plain tensor, it returns its input.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Optional, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

MeshAxis = Union[None, str, tuple[str, ...]]


class Spec(tuple):
    """Partition spec: entries per tensor dim, trailing Nones dropped."""

    def __new__(cls, *entries: MeshAxis) -> "Spec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis name -> physical mesh dim(s) (or None)."""

    rules: dict[str, MeshAxis] = field(default_factory=dict)

    def spec(self, logical_axes: tuple[Optional[str], ...]) -> Spec:
        used: list[str] = []
        out: list[MeshAxis] = []
        for ax in logical_axes:
            phys = self.rules.get(ax) if ax is not None else None
            # a physical dim may appear at most once in a spec
            if phys is None:
                out.append(None)
                continue
            flat = (phys,) if isinstance(phys, str) else tuple(phys)
            flat = tuple(a for a in flat if a not in used)
            if not flat:
                out.append(None)
                continue
            used.extend(flat)
            out.append(flat[0] if len(flat) == 1 else flat)
        while out and out[-1] is None:
            out.pop()
        return Spec(*out)

    def with_overrides(self, **kw: MeshAxis) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(kw)
        return ShardingRules(merged)


# ---------------------------------------------------------------------------
# Rule tables (copies of the reference's).
# ---------------------------------------------------------------------------
# FSDP x TP training layout: weights sharded over "data" on their d_model
# axis (FSDP) and over "model" on their ff / heads axis (Megatron TP),
# replicated across pods; the batch is split over (pod, data).
TRAIN_RULES = ShardingRules(
    {
        # params
        "layers": None,
        "embed": "data",
        "q_heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "qkv_dim": "model",
        "ff": "model",
        "vocab": "model",
        "experts": None,
        "lru": "model",
        "lru_heads": "model",
        "conv": None,
        "rank": None,
        # activations
        "act_batch": ("pod", "data"),
        "act_seq": None,
        # sequence parallelism: the residual stream at layer boundaries is
        # sequence-sharded over the TP dim
        "act_res_seq": "model",
        "act_embed": None,
        "act_ff": "model",
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_vocab": "model",
        "act_experts": None,
        "act_lru": "model",
        # kv cache
        "cache_batch": ("pod", "data"),
        "cache_seq": None,
    }
)

# Inference layout: KV caches batch-sharded over data and sequence-sharded
# over the TP dim.
SERVE_RULES = TRAIN_RULES.with_overrides(
    act_batch=("pod", "data"),
    cache_batch=("pod", "data"),
    cache_seq="model",
)

LONG_CONTEXT_RULES = SERVE_RULES.with_overrides(
    act_batch=None,
    cache_batch=None,
    cache_seq=("pod", "data", "model"),  # batch=1: every dim on the sequence
)


# ---------------------------------------------------------------------------
# Mesh context
# ---------------------------------------------------------------------------
class _Ctx(threading.local):
    mesh: Any = None
    rules: Optional[ShardingRules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def mesh_context(mesh: Any, rules: ShardingRules):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_rules() -> Optional[ShardingRules]:
    return _CTX.rules


def current_mesh() -> Any:
    return _CTX.mesh


def mesh_shape(mesh: Any) -> dict[str, int]:
    """{dim name: size} of a DeviceMesh, or a stand-in whose ``shape`` is
    such a mapping."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(shape, axes, mesh: Any, rules: ShardingRules,
             dropped: Optional[list] = None) -> Spec:
    """Shape-aware spec: drops mesh dims that are absent from the mesh, used
    already, or do not divide the tensor dim (recorded in ``dropped`` as
    (logical axis, mesh dim, size))."""
    sizes = mesh_shape(mesh)
    used: list[str] = []
    entries: list[MeshAxis] = []
    for dim, ax in zip(shape, axes):
        phys = rules.rules.get(ax) if ax is not None else None
        if phys is None:
            entries.append(None)
            continue
        flat = (phys,) if isinstance(phys, str) else tuple(phys)
        flat = tuple(a for a in flat if a in sizes and a not in used)
        keep: list[str] = []
        prod = 1
        for a in flat:
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
            elif dropped is not None:
                dropped.append((ax, a, dim))
        if not keep:
            entries.append(None)
            continue
        used.extend(keep)
        entries.append(keep[0] if len(keep) == 1 else tuple(keep))
    while entries and entries[-1] is None:
        entries.pop()
    return Spec(*entries)


def placements(spec: Spec, mesh: Any) -> tuple:
    """One placement per mesh dim: Shard(i) where tensor dim i's entry names
    the mesh dim, else Replicate() (also over a mesh dim of size 1, where
    the two are the same layout and DTensor views only the latter freely).
    Raises for a tuple entry that is not in mesh order, or a name the mesh
    does not have."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    out: list = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        flat = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in flat:
            if a not in names:
                raise ValueError(f"mesh dim {a!r} of {spec} is not in the mesh {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order {names}: DTensor "
                             f"splits a tensor dim over mesh dims in mesh order")
        for j in idx:
            if sizes[names[j]] > 1:
                out[j] = Shard(i)
    return tuple(out)


def placements_for(shape, axes, mesh: Any = None,
                   rules: Optional[ShardingRules] = None) -> tuple:
    """``placements`` of ``spec_for`` under the given, or the current, mesh
    and rules."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules if rules is not None else _CTX.rules
    return placements(spec_for(shape, axes, mesh, rules), mesh)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient too (as
    ``with_sharding_constraint`` constrains the cotangent): the backward of
    a view that DTensor cannot take on an unevenly sharded gradient then
    gets the forward's layout."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) != placements:
            return x.redistribute(x.device_mesh, placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor (and its gradient) to the rules' placements
    inside a mesh context; otherwise return ``x``."""
    if _CTX.mesh is None or _CTX.rules is None or not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, placements_for(x.shape, tuple(logical_axes)))


def constrain_view(x: torch.Tensor, shape: tuple, *logical_axes: Optional[str]) -> torch.Tensor:
    """``x.view(shape)`` where ``shape`` splits ``x``'s last dim in two, or
    merges its last two; ``logical_axes`` name the dims of the longer of the
    two shapes.  On a DTensor inside a mesh context the split side is held
    to the rules' placements, in the forward and in the backward: DTensor
    cannot unflatten a dim sharded over a mesh dim that does not divide the
    first of the new dims (3 heads over a model dim of 2)."""
    if _CTX.mesh is None or _CTX.rules is None or not isinstance(x, DTensor):
        return x.view(shape)
    split = len(shape) > x.ndim
    long = tuple(shape) if split else tuple(x.shape)
    pl = placements_for(long, tuple(logical_axes))
    if split:
        return _Constrain.apply(x, pl).view(shape)
    return _Constrain.apply(x.view(shape), pl)


def gather_fsdp(tree: Any) -> Any:
    """Weights as a layer uses them: inside a mesh context each DTensor of
    ``tree`` (a dict of weights, nested) gathered over the mesh dims that
    shard the batch (``act_batch``'s: the FSDP dims), its tensor-parallel
    shards kept, as XLA gathers an FSDP weight before its matmul; the
    gradient comes back reduce-scattered to the weight's own layout.
    Without it DTensor may shard a matmul's contraction instead and leave
    its output a partial sum over the batch's dims (the whole logits of a
    step all-reduced at a small batch).  Otherwise ``tree``."""
    if _CTX.mesh is None or _CTX.rules is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    batch = _CTX.rules.rules.get("act_batch")
    batch = {batch} if isinstance(batch, str) else set(batch or ())
    names = tree.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if isinstance(p, Shard) and names[i] in batch else p
               for i, p in enumerate(tree.placements))
    return tree if pl == tuple(tree.placements) else tree.redistribute(tree.device_mesh, pl)


def distribute_as(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Inside a mesh context, a full tensor that every rank holds alike as
    a DTensor placed by the rules (each rank keeps its shard; nothing is
    sent); otherwise ``x``."""
    if _CTX.mesh is None or _CTX.rules is None:
        return x
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, _CTX.mesh, placements_for(x.shape, tuple(logical_axes)),
                             src_data_rank=None)


def recompute_contexts():
    """``context_fn`` for ``torch.utils.checkpoint``: the recompute, which
    the autograd engine may run on a thread of its own (it does for CUDA
    tensors), runs in the forward's mesh context, with plain tensors as
    replicated; nothing changes off a mesh."""
    mesh, rules = _CTX.mesh, _CTX.rules

    @contextlib.contextmanager
    def again():
        if mesh is None:
            yield
            return
        with mesh_context(mesh, rules), plain_as_replicated():
            yield

    return contextlib.nullcontext(), again()


def plain_as_replicated():
    """Inside a mesh context, plain tensors met beside DTensors count as
    replicated (RoPE tables, masks, optimizer scalars); otherwise nothing.
    Nests: leaving an inner one (a remat recompute's, inside the backward
    of an outer one) keeps the outer one in force, where torch's
    ``implicit_replication`` would turn it off."""
    if _CTX.mesh is None:
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    dispatcher = DTensor._op_dispatcher
    if not hasattr(dispatcher, "_allow_implicit_replication"):  # another torch
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            yield
        return
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev
