"""Static (dimension-ordered) vs adaptive routing + collective bandwidth.

Adaptive routing here means per-flow path selection that avoids degraded /
loaded links (the torus analogue of IB AR's per-packet output-port
selection): each flow considers the minimal X-then-Y and Y-then-X routes
plus single-detour variants and picks the best under current link state.

Collective model: a ring all-reduce over a node set is a cycle of
node-to-node flows; each flow's bandwidth is bottlenecked by its worst
link after congestion sharing; the ring moves at the slowest flow, and
algorithm bandwidth = min_flow_bw (x 2(n-1)/n data factor handled by the
caller when converting to algo bandwidth).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.fabric.topology import Link, Torus2D


def _dor_path(t: Torus2D, src: int, dst: int, x_first: bool = True) -> list[tuple[int, int]]:
    """Dimension-ordered minimal route (shortest wrap direction)."""
    sx, sy = t.coords(src)
    dx, dy = t.coords(dst)
    path = []

    def step_axis(cur, target, axis):
        nonlocal path
        cx, cy = t.coords(cur)
        c = cx if axis == 0 else cy
        tgt = target
        n = t.nx if axis == 0 else t.ny
        delta = (tgt - c) % n
        direction = 1 if delta <= n - delta else -1
        steps = min(delta, n - delta)
        for _ in range(steps):
            nxt = t.nid(cx + direction, cy) if axis == 0 \
                else t.nid(cx, cy + direction)
            path.append((cur, nxt))
            cur = nxt
            cx, cy = t.coords(cur)
        return cur

    cur = src
    if x_first:
        cur = step_axis(cur, dx, 0)
        cur = step_axis(cur, dy, 1)
    else:
        cur = step_axis(cur, dy, 1)
        cur = step_axis(cur, dx, 0)
    return path


def static_route(t: Torus2D, src: int, dst: int, load=None) -> list[tuple[int, int]]:
    return _dor_path(t, src, dst, x_first=True)


def adaptive_route(t: Torus2D, src: int, dst: int,
                   load: Optional[dict] = None) -> list[tuple[int, int]]:
    """Pick the best candidate path under link health + current load."""
    load = load or {}
    candidates = [
        _dor_path(t, src, dst, x_first=True),
        _dor_path(t, src, dst, x_first=False),
    ]
    # single-detour candidates through a random-ish intermediate neighbor
    for mid in t.neighbors(src)[:2]:
        if mid not in (src, dst):
            candidates.append(_dor_path(t, src, mid) + _dor_path(t, mid, dst))

    def path_cost(path):
        worst = 0.0
        total = 0.0
        for (a, b) in path:
            l = t.link(a, b)
            cap = l.effective_capacity
            if cap <= 0:
                return float("inf")
            flows = load.get(l.key(), 0) + 1
            c = flows / cap
            worst = max(worst, c)
            total += c
        return worst * 1e9 + total  # bottleneck first, then total

    return min(candidates, key=path_cost)


def ring_allreduce_bandwidth(
    t: Torus2D,
    members: list[int],
    router: Callable = static_route,
    *,
    existing_load: Optional[dict] = None,
    payload_factor: float = 1.0,
) -> tuple[float, dict]:
    """Effective per-rank algorithm bandwidth of a ring all-reduce.

    Returns (bandwidth bytes/s, link load dict after placing the ring)."""
    load = dict(existing_load or {})
    flows = []
    for i in range(len(members)):
        src, dst = members[i], members[(i + 1) % len(members)]
        if src == dst:
            continue
        path = router(t, src, dst, load)
        for (a, b) in path:
            k = t.link(a, b).key()
            load[k] = load.get(k, 0) + 1
        flows.append(path)
    # each flow's rate = min over links of cap/flows; ring moves at slowest
    slowest = float("inf")
    for path in flows:
        rate = float("inf")
        for (a, b) in path:
            l = t.link(a, b)
            cap = l.effective_capacity
            n_flows = load.get(l.key(), 1)
            rate = min(rate, cap / max(n_flows, 1))
        slowest = min(slowest, rate)
    if not flows:
        slowest = float("inf")
    n = max(len(members), 2)
    # ring all-reduce algorithm bandwidth: payload moves 2(n-1)/n per rank
    algo_bw = slowest * n / (2.0 * (n - 1)) * payload_factor
    return algo_bw, load
