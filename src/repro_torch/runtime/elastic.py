"""Elastic re-meshing: continue a run on fewer ranks after failures (after
``repro.runtime.elastic``).

The paper's clusters handle node loss by requeueing onto healthy nodes;
when spare capacity is thin (the common case at >80% utilization), an
elastic job can instead shrink to the surviving allocation at the next
restart boundary.  Checkpoints are topology-agnostic (full tensors keyed by
path, ``host_tree``) and the data pipeline is a pure function of (seed,
step), so resuming on another mesh is: start the survivors' process group
as a new launch, rebuild the mesh, re-place the restored tensors, and go on
at the same data step.

``plan_shrink`` chooses the largest valid (data, model) mesh for the
survivors; ``make_elastic_mesh`` builds it over the first data * model
ranks; ``reshard_for`` places the restored tensors on it, and
``reshard_state_for`` the restored AdamW state (f32 or 8-bit).  The shrunk run
is a new launch of the survivors, not a sub-mesh of the old world: a
DeviceMesh builds its groups with ``new_group``, which every rank of the
default group has to call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.parallel.axes import ShardingRules


@dataclass(frozen=True)
class ShrinkPlan:
    n_alive: int
    data: int
    model: int
    global_batch: int
    note: str = ""


def plan_shrink(n_alive_devices: int, *, model_parallel: int,
                old_global_batch: int, old_data: int) -> ShrinkPlan:
    """Largest usable mesh: keep the TP degree (the weights' shard layout),
    shrink the data dim; the batch shrinks proportionally (a constant
    per-replica batch keeps step time and optimizer dynamics stable under
    linear-scaling LR rules)."""
    if n_alive_devices < model_parallel:
        raise ValueError(
            f"cannot keep TP={model_parallel} with {n_alive_devices} devices")
    data = n_alive_devices // model_parallel
    per_replica = max(1, old_global_batch // old_data)
    new_batch = per_replica * data
    return ShrinkPlan(n_alive_devices, data, model_parallel, new_batch,
                      note=f"kept TP={model_parallel}, data {old_data}->{data}")


def make_elastic_mesh(plan: ShrinkPlan, device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over ranks 0 .. data * model - 1 of the
    survivors' process group."""
    n = plan.data * plan.model
    world = torch.distributed.get_world_size()
    if world < n:
        raise ValueError(f"the plan needs {n} ranks; the process group has {world}")
    ranks = torch.arange(n).reshape(plan.data, plan.model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def reshard_for(tree: dict, mesh: DeviceMesh, rules: ShardingRules, defs: Any) -> dict:
    """Place restored full tensors (every rank holding the same values) on
    ``mesh`` as ``params.shardings`` gives them; {path: DTensor}."""
    from repro_torch.models.params import shardings as mk_shardings

    sh = mk_shardings(defs, mesh, rules)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return {path: distribute_tensor(t.to(dev), mesh, sh[path], src_data_rank=None)
            for path, t in tree.items()}


def reshard_state_for(state, mesh: DeviceMesh, rules: ShardingRules, defs: Any):
    """A restored AdamW state (full tensors, every rank holding the same
    values) placed on ``mesh`` as ``adamw.init`` / ``adamw.init_8bit`` place
    it: an f32 moment as its parameter, an 8-bit moment's int8 codes as the
    parameter and its f32 block scales by ``adamw.scale_placements``; the
    step on the mesh's device."""
    from repro_torch.models.params import shardings as mk_shardings
    from repro_torch.optim import adamw

    sh = mk_shardings(defs, mesh, rules)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)

    def place(path, e):
        if not isinstance(e, dict):
            return distribute_tensor(e.to(dev), mesh, sh[path], src_data_rank=None)
        s_pl = adamw.scale_placements(e["q"].shape, sh[path], mesh)
        return {"q": distribute_tensor(e["q"].to(dev), mesh, sh[path], src_data_rank=None),
                "s": distribute_tensor(e["s"].to(dev), mesh, s_pl, src_data_rank=None)}

    return adamw.AdamWState(state.step.to(dev), {k: place(k, e) for k, e in state.m.items()},
                            {k: place(k, e) for k, e in state.v.items()})


def host_tree(tree: dict) -> dict:
    """Full tensors on the host of a tree of DTensors (every rank takes part
    in the gathers), as a topology-agnostic checkpoint holds them; plain
    tensors are copied to the host as they are, and nested dicts (an 8-bit
    moment's {"q", "s"}) keep their keys."""
    return {path: host_tree(t) if isinstance(t, dict) else
            (t.full_tensor() if isinstance(t, DTensor) else t).detach().cpu()
            for path, t in tree.items()}
