"""GPipe-style pipeline parallelism over a ``stage`` mesh dim (after
``repro.parallel.pipeline``).

The production mesh for the paper's workloads is FSDP x TP (+ pod DP), so
pipelining is an optional dim, exercised by tests and available for
memory-constrained configs.  Each stage rank holds its slice of the stacked
(n_stages, layers_per_stage, ...) weights; microbatches stream through, and
each step hands the in-flight activation to the next stage with
``batch_isend_irecv`` (the reference's ``ppermute``).  The bubble fraction
is (S - 1) / (M + S - 1) for S stages and M microbatches.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _index(tree: Any, i: int) -> Any:
    """Leaf-wise ``leaf[i]`` of a tensor, dict or list."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, i) for v in tree)
    return tree[i]


def _leading(tree: Any) -> int:
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


def pipeline_forward(
    layer_fn: Callable,    # (params_slice, x) -> x
    stage_params: Any,     # stacked (n_stages, layers_per_stage, ...) tensors
    x: torch.Tensor,       # (n_microbatches, mb, seq, d), the same on every rank
    mesh: Any,
    axis: str = "stage",
) -> torch.Tensor:
    """A GPipe forward pass over the ``axis`` mesh dim: n_micro + n_stages -
    1 steps; each returns the last stage's outputs on every rank (summed
    over the stage group, where only the last stage wrote any)."""
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_micro = x.shape[0]
    local = _index(stage_params, stage)  # (layers_per_stage, ...)
    layers = _leading(local)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)

    state = torch.zeros_like(x[0])  # the in-flight activation
    outputs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        if stage == 0 and t < n_micro:  # stage 0 takes microbatch t
            state = x[t]
        for i in range(layers):
            state = layer_fn(_index(local, i), state)
        emit_t = t - (n_stages - 1)  # the last stage emits microbatch t - (S - 1)
        if stage == n_stages - 1 and emit_t >= 0:
            outputs[emit_t] = state
        if n_stages > 1:  # hand the activation to the next stage
            recv = torch.empty_like(state)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, state.contiguous(), nxt, group=group),
                dist.P2POp(dist.irecv, recv, prv, group=group)])
            for req in reqs:
                req.wait()
            state = recv
    dist.all_reduce(outputs, group=group)
    return outputs
