"""Parameter definitions: shape + logical axes + dtype + initializer (after
``repro.models.params``).

A model is described by a nested dict/list of :class:`ParamDef`; leaves are
named by the flatten path the reference's checkpoints use
(``groups/0/p0/attn/wq``).  From it come the initialized parameters
(``materialize``) and, through the logical-axis rules, each parameter's
DTensor placements on a mesh (``shardings``).  Resolution is shape aware,
as the reference's: a mesh dim that does not divide a dimension is dropped
and recorded.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.parallel.axes import ShardingRules, placements, spec_for


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axis names, one per dim
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | custom
    init_scale: float = 1.0
    # used when init == "custom": init_fn(shape, dtype, generator) -> tensor
    # on generator.device
    init_fn: Optional[Callable] = None

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"logical axes {self.axes} do not match shape {self.shape}")


def flatten(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in the reference's flatten order: dict keys
    sorted, list items by index, path parts joined with '/'."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from flatten(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from flatten(item, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def normal_init(shape: tuple[int, ...], dtype: torch.dtype, scale: float,
                generator: torch.Generator) -> torch.Tensor:
    # fan-in over the *stacked* shape, as in the reference
    fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
    std = scale / math.sqrt(max(fan_in, 1))
    out = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)
    return out.mul_(std).to(dtype)


def materialize(defs: Any, seed: int = 0,
                device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Initialize every ParamDef directly on ``device``; keyed by path."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for path, d in flatten(defs):
        if d.init == "zeros":
            out[path] = torch.zeros(d.shape, dtype=d.dtype, device=device)
        elif d.init == "ones":
            out[path] = torch.ones(d.shape, dtype=d.dtype, device=device)
        elif d.init == "custom":
            out[path] = d.init_fn(d.shape, d.dtype, gen)
        else:
            out[path] = normal_init(d.shape, d.dtype, d.init_scale, gen)
    return out


def shardings(defs: Any, mesh: Any, rules: ShardingRules,
              dropped: Optional[list] = None) -> dict[str, tuple]:
    """{path: DTensor placements} of every ParamDef on ``mesh`` under
    ``rules``; mesh dims dropped for not dividing a dim go to ``dropped``."""
    out = {}
    for path, d in flatten(defs):
        out[path] = placements(spec_for(d.shape, d.axes, mesh, rules, dropped), mesh)
    return out


def cast_defs(defs: Any, dtype: torch.dtype) -> Any:
    """Re-type all float params (e.g. bf16 serving weights)."""
    if isinstance(defs, dict):
        return {k: cast_defs(v, dtype) for k, v in defs.items()}
    if isinstance(defs, (list, tuple)):
        return [cast_defs(v, dtype) for v in defs]
    return dataclasses.replace(defs, dtype=dtype) if defs.dtype.is_floating_point else defs
