"""Per-rank cost of a traced step: the counterpart of ``repro.launch.hlo_analysis``.

The reference parses the XLA module a compile produced.  Eager PyTorch has
no such module, so the step is run once under a dispatch mode (on fake
tensors in the dry run) and every aten op one rank runs is counted:

  * FLOPs: ``torch.utils.flop_counter``'s formula for each op it knows
    (the products), plus the kernels' work (``kernels.cost.fake``: a
    kernel launches through ctypes, so no aten op shows it);
  * bytes: each op's inputs and outputs (eager PyTorch fuses nothing, so
    that is what it moves), views and bare allocations excepted, plus the
    kernels' bytes;
  * collectives: each ``_c10d_functional`` op DTensor issues, as bytes
    moved by the reference's ring factors (``moved``), split by whether its
    group crosses a node of ``pod_size`` ranks (the NVLink domain).

DTensor ops are let through (``NotImplemented``) so that the mode sees the
local ops on each rank's shards, never the global ones.  DTensor's
planning (it runs each op once more on global shapes to learn the
output's metadata, and builds small index tensors to plan a
redistribution) runs outside every dispatch mode while ``TraceCounter`` is
entered, as it runs outside any in an eager step: neither it nor a memory
tracker counts that work, and no fake tensor reaches the planner.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost

# c10d_functional op name -> the reference's collective kind
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
    "permute_tensor": "collective-permute",
}
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def moved(kind: str, size: float, g: int) -> float:
    """Bytes a ring moves for one collective whose result is ``size`` bytes
    over a group of ``g`` (``hlo_analysis``'s factors): all-reduce
    2 (g - 1) / g, all-gather (g - 1) / g, reduce-scatter (g - 1) times the
    shard, a permute its size, all-to-all and the rest (g - 1) / g."""
    if kind == "all-reduce":
        return 2.0 * size * (g - 1) / max(g, 1)
    if kind == "all-gather":
        return size * (g - 1) / max(g, 1)
    if kind == "reduce-scatter":
        return float(size) * (g - 1)
    if kind == "collective-permute":
        return float(size)
    return size * (g - 1) / max(g, 1)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _group(name: str) -> list[int]:
    pg = dist.distributed_c10d._resolve_process_group(name)
    return dist.get_process_group_ranks(pg)


# DTensor's planning: the output metadata of an op on global shapes, its
# sharding strategy, the steps of a redistribution; (module, owner, name)
_PLANNING = (("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
              "_propagate_tensor_meta_non_cached"),
             ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
              "propagate_op_sharding_non_cached"),
             ("torch.distributed.tensor._redistribute", None, "_gen_transform_infos_non_cached"),
             ("torch.distributed.tensor.placement_types", "_StridedShard",
              "local_shard_size_and_offset"))


@contextlib.contextmanager
def _quiet_planning():
    """DTensor's planning run outside the dispatch modes (and so outside a
    ``FakeTensorMode``) for the length of the trace, as in an eager step:
    it computes metadata on global shapes and small index tensors, none of
    which is a rank's work."""
    import importlib
    import inspect

    saved = []
    for mod_name, owner_name, name in _PLANNING:
        owner = importlib.import_module(mod_name)
        if owner_name:
            owner = getattr(owner, owner_name, None)
        raw = inspect.getattr_static(owner, name, None) if owner is not None else None
        if raw is None:  # another torch's planner: leave it
            continue
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw

        def quiet(*args, __fn=fn, **kwargs):
            with _disable_current_modes():
                return __fn(*args, **kwargs)

        saved.append((owner, name, raw))
        setattr(owner, name, staticmethod(quiet) if isinstance(raw, staticmethod) else quiet)
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


class TraceCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes and collectives while it is entered
    (see the module's doc); ``kernel_flops`` and ``kernel_bytes`` are the
    kernels' fake-route work over the same span."""

    def __init__(self, pod_size: int = 8):
        super().__init__()
        self.pod_size = pod_size
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernel_calls: dict = {}
        self.coll = {"per_op": defaultdict(lambda: {"count": 0, "bytes_moved": 0.0}),
                     "intra_pod_bytes": 0.0, "cross_pod_bytes": 0.0}
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        cost.reset()
        self._stack.enter_context(_quiet_planning())
        return super().__enter__()

    def __exit__(self, *exc):
        self.kernel_flops, self.kernel_bytes = cost.fake["flops"], cost.fake["bytes"]
        self.kernel_calls = dict(cost.fake["calls"])
        cost.reset()
        self._stack.close()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "_c10d_functional_autograd"):
            if name in COLLECTIVES:
                self.collective(COLLECTIVES[name], max(map(_nbytes, _tensors(out)), default=0),
                                _group(kwargs.get("group_name", args[-1])))
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view and name not in _ALLOC:
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs)))) + sum(
                map(_nbytes, _tensors(out)))
        return out

    def collective(self, kind: str, size: int, ranks: list[int]) -> None:
        """Count one collective whose result is ``size`` bytes over the
        group of ``ranks``."""
        g = len(ranks)
        if kind == "collective-permute":
            g = 2
        if g <= 1:
            return
        m = moved(kind, size, g)
        ent = self.coll["per_op"][kind]
        ent["count"] += 1
        ent["bytes_moved"] += m
        if len({r // self.pod_size for r in ranks}) > 1:
            self.coll["cross_pod_bytes"] += m
        else:
            self.coll["intra_pod_bytes"] += m
        self.bytes += 2 * size

    def summary(self) -> dict:
        """The reference's ``analyze_module`` record, per rank."""
        coll = {"per_op": {k: dict(v) for k, v in self.coll["per_op"].items()},
                "intra_pod_bytes": self.coll["intra_pod_bytes"],
                "cross_pod_bytes": self.coll["cross_pod_bytes"]}
        coll["total_bytes"] = coll["intra_pod_bytes"] + coll["cross_pod_bytes"]
        return {"flops": self.flops + self.kernel_flops,
                "bytes": self.bytes + self.kernel_bytes,
                "aten_flops": self.flops, "aten_bytes": self.bytes,
                "kernel_flops": self.kernel_flops, "kernel_bytes": self.kernel_bytes,
                "kernel_calls": self.kernel_calls,
                "collectives": coll}
