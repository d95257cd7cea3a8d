"""Input specs and placements for every (arch x shape x step) cell (after
``repro.launch.specs``).

``input_specs`` gives the step's arguments as tensors that hold no data:
on ``meta`` by default (the reference's ``ShapeDtypeStruct``), or, inside a
``FakeTensorMode``, fake tensors on the device asked for, which the dry run
places on its mesh.  ``input_shardings`` / ``output_shardings`` give the
matching DTensor placements, one tuple a tensor, from ``spec_for`` and
``params.shardings`` (the reference's ``NamedSharding`` trees).  A mesh is
a DeviceMesh or a stand-in whose ``shape`` maps dim names to sizes.

Trees are the port's: params and the moments are flat dicts keyed by
flatten path (an 8-bit moment an {"q", "s"} entry), the cache is
``transformer.init_cache``'s.
"""
from __future__ import annotations

import math
import os
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import params as pmod
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.parallel.axes import (LONG_CONTEXT_RULES, SERVE_RULES, TRAIN_RULES,
                                       ShardingRules, placements, spec_for)

COMPUTE_DTYPE = torch.bfloat16


def rules_for(shape: ShapeSpec) -> ShardingRules:
    if shape.kind == "train":
        return TRAIN_RULES
    if shape.name == "long_500k":
        return LONG_CONTEXT_RULES
    return SERVE_RULES


def enc_len(cfg: ArchConfig, seq_len: int) -> int:
    return int(seq_len * cfg.enc_len_ratio)


def _empty(shape: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Batch and cache specs
# ---------------------------------------------------------------------------
def batch_struct(cfg: ArchConfig, shape: ShapeSpec, device="meta") -> tuple[dict, dict]:
    """(tensor tree, logical-axes tree) of the data batch."""
    B, S = shape.global_batch, shape.seq_len
    n_text = {"train": S - cfg.n_patches + 1, "prefill": S - cfg.n_patches, "decode": 1}
    struct = {"tokens": _empty((B, n_text[shape.kind]), torch.int32, device)}
    axes = {"tokens": ("act_batch", None)}
    if shape.kind == "decode":
        return struct, axes
    if cfg.n_patches:
        struct["patches"] = _empty((B, cfg.n_patches, cfg.d_model), COMPUTE_DTYPE, device)
        axes["patches"] = ("act_batch", "act_seq", None)
    if cfg.enc_dec:
        struct["frames"] = _empty((B, enc_len(cfg, S), cfg.d_model), COMPUTE_DTYPE, device)
        axes["frames"] = ("act_batch", "act_seq", None)
    return struct, axes


def cache_struct(cfg: ArchConfig, shape: ShapeSpec, device="meta") -> tuple[dict, dict]:
    B, S = shape.global_batch, shape.seq_len
    return (transformer.init_cache(cfg, B, S, enc_len(cfg, S), dtype=COMPUTE_DTYPE,
                                   device=device),
            transformer.cache_axes(cfg))


# ---------------------------------------------------------------------------
# Full argument specs per step kind
# ---------------------------------------------------------------------------
def train_defs(cfg: ArchConfig) -> dict:
    return transformer.model_defs(cfg)  # f32 master weights


def serve_defs(cfg: ArchConfig) -> dict:
    return pmod.cast_defs(transformer.model_defs(cfg), COMPUTE_DTYPE)


def _opt8bit() -> bool:
    return os.environ.get("REPRO_OPT8BIT") == "1"


def _quantized(shape: tuple) -> bool:
    return _opt8bit() and len(shape) >= 1 and math.prod(shape) >= adamw.QUANT_MIN_SIZE


def _params(defs: Any, device) -> dict:
    return {path: _empty(d.shape, d.dtype, device) for path, d in pmod.flatten(defs)}


def _moments(defs: Any, device) -> dict:
    """A moment tree: f32 like the params, or with ``REPRO_OPT8BIT=1`` an
    int8 {"q"} and its f32 block scales {"s"} for each leaf of at least
    ``adamw.QUANT_MIN_SIZE`` elements."""
    out = {}
    for path, d in pmod.flatten(defs):
        if _quantized(d.shape):
            out[path] = {"q": _empty(d.shape, torch.int8, device),
                         "s": _empty(adamw._scale_shape(d.shape), torch.float32, device)}
        else:
            out[path] = _empty(d.shape, torch.float32, device)
    return out


def input_specs(cfg: ArchConfig, shape: ShapeSpec, device="meta"):
    """The cell's step arguments:

    train   -> (params, opt_state, batch)
    prefill -> (params, batch)
    decode  -> (params, cache, tokens)
    """
    if shape.kind == "train":
        defs = train_defs(cfg)
        opt = adamw.AdamWState(step=_empty((), torch.int32, device), m=_moments(defs, device),
                               v=_moments(defs, device))
        return _params(defs, device), opt, batch_struct(cfg, shape, device)[0]
    params = _params(serve_defs(cfg), device)
    if shape.kind == "prefill":
        return params, batch_struct(cfg, shape, device)[0]
    return (params, cache_struct(cfg, shape, device)[0],
            batch_struct(cfg, shape, device)[0]["tokens"])


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------
def _tree_placements(struct: Any, axes: Any, mesh: Any, rules: ShardingRules,
                     dropped: Optional[list] = None) -> Any:
    if isinstance(struct, dict):
        return {k: _tree_placements(struct[k], axes[k], mesh, rules, dropped) for k in struct}
    if isinstance(struct, (list, tuple)):
        return [_tree_placements(s, a, mesh, rules, dropped) for s, a in zip(struct, axes)]
    return placements(spec_for(struct.shape, axes, mesh, rules, dropped), mesh)


def _moment_placements(defs: Any, mesh: Any, rules: ShardingRules,
                       dropped: Optional[list] = None) -> dict:
    out = pmod.shardings(defs, mesh, rules, dropped)
    for path, d in pmod.flatten(defs):
        if _quantized(d.shape):
            out[path] = {"q": out[path],
                         "s": placements(spec_for(adamw._scale_shape(d.shape), d.axes, mesh, rules),
                                         mesh)}
    return out


def input_shardings(cfg: ArchConfig, shape: ShapeSpec, mesh: Any,
                    rules: Optional[ShardingRules] = None, dropped: Optional[list] = None):
    """Placement trees matching ``input_specs(cfg, shape)``; mesh dims dropped
    for not dividing a dim go to ``dropped``."""
    rules = rules or rules_for(shape)
    rep = placements(spec_for((), (), mesh, rules), mesh)
    batch, batch_axes = batch_struct(cfg, shape)
    b_pl = _tree_placements(batch, batch_axes, mesh, rules, dropped)
    if shape.kind == "train":
        defs = train_defs(cfg)
        m_pl = _moment_placements(defs, mesh, rules, dropped)
        return (pmod.shardings(defs, mesh, rules, dropped),
                adamw.AdamWState(step=rep, m=m_pl, v=m_pl), b_pl)
    p_pl = pmod.shardings(serve_defs(cfg), mesh, rules, dropped)
    if shape.kind == "prefill":
        return p_pl, b_pl
    cache, cache_ax = cache_struct(cfg, shape)
    return p_pl, _tree_placements(cache, cache_ax, mesh, rules, dropped), b_pl["tokens"]


def output_shardings(cfg: ArchConfig, shape: ShapeSpec, mesh: Any,
                     rules: Optional[ShardingRules] = None):
    """Placements of the step's outputs: (params, opt_state, metrics)
    replicated metrics for train; (logits (B, 1, V), cache) to serve."""
    rules = rules or rules_for(shape)
    if shape.kind == "train":
        p_pl, opt_pl, _ = input_shardings(cfg, shape, mesh, rules)
        return p_pl, opt_pl, placements(spec_for((), (), mesh, rules), mesh)
    logits = placements(spec_for((shape.global_batch, 1, cfg.vocab_size),
                                 ("act_batch", None, "act_vocab"), mesh, rules), mesh)
    cache, cache_ax = cache_struct(cfg, shape)
    return logits, _tree_placements(cache, cache_ax, mesh, rules)
