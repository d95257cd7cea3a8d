"""Fabric topology model: 2-D torus of nodes with per-link state.

The paper's clusters use a rail-optimized InfiniBand Clos; the TPU-idiomatic
equivalent (DESIGN.md §3) is a torus ICI fabric where link failures are
routed *around* rather than through switch-level rerouting.  Links carry a
health state: healthy, degraded (bit errors -> retransmissions -> reduced
effective capacity), or down.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

LINK_BW = 50e9  # bytes/s per ICI link


@dataclass
class Link:
    a: int
    b: int
    capacity: float = LINK_BW
    degradation: float = 0.0   # 0 = healthy; 0.9 = 90% capacity lost
    down: bool = False

    @property
    def effective_capacity(self) -> float:
        if self.down:
            return 0.0
        return self.capacity * (1.0 - self.degradation)

    def key(self) -> tuple[int, int]:
        return (self.a, self.b) if self.a < self.b else (self.b, self.a)


class Torus2D:
    """nx x ny bidirectional torus; node id = x * ny + y."""

    def __init__(self, nx: int, ny: int, capacity: float = LINK_BW):
        self.nx, self.ny = nx, ny
        self.links: dict[tuple[int, int], Link] = {}
        for x in range(nx):
            for y in range(ny):
                i = self.nid(x, y)
                for j in (self.nid((x + 1) % nx, y), self.nid(x, (y + 1) % ny)):
                    k = (i, j) if i < j else (j, i)
                    if k not in self.links:
                        self.links[k] = Link(k[0], k[1], capacity)

    def nid(self, x: int, y: int) -> int:
        return (x % self.nx) * self.ny + (y % self.ny)

    def coords(self, i: int) -> tuple[int, int]:
        return divmod(i, self.ny)

    @property
    def n_nodes(self) -> int:
        return self.nx * self.ny

    def link(self, i: int, j: int) -> Link:
        return self.links[(i, j) if i < j else (j, i)]

    def neighbors(self, i: int) -> list[int]:
        x, y = self.coords(i)
        return [self.nid(x + 1, y), self.nid(x - 1, y),
                self.nid(x, y + 1), self.nid(x, y - 1)]

    def degrade_links(self, frac: float, degradation: float,
                      rng: np.random.Generator) -> list[tuple[int, int]]:
        keys = list(self.links)
        chosen = rng.choice(len(keys), max(1, int(frac * len(keys))),
                            replace=False)
        out = []
        for c in chosen:
            self.links[keys[int(c)]].degradation = degradation
            out.append(keys[int(c)])
        return out

    def heal(self) -> None:
        for l in self.links.values():
            l.degradation = 0.0
            l.down = False
