"""Figure 12 experiments on the torus fabric model.

(a) 512-GPU (8x8-node) ring all-reduce under injected link errors, static
    vs adaptive routing, 5 iterations (paper: without resilience >50% of
    bandwidth is lost; AR maintains much higher bandwidth).
(b) 32 concurrent 2-node (16-GPU) all-reduce groups contending on a 64-node
    fabric: AR achieves higher mean bandwidth and lower variance.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.fabric.routing import (adaptive_route, ring_allreduce_bandwidth,
                                        static_route)
from repro_torch.fabric.topology import LINK_BW, Torus2D


@dataclass
class ARResult:
    static_bw: list
    adaptive_bw: list

    def summary(self) -> dict:
        s = np.array(self.static_bw) / LINK_BW
        a = np.array(self.adaptive_bw) / LINK_BW
        return {
            "static_mean": float(s.mean()), "static_std": float(s.std()),
            "adaptive_mean": float(a.mean()), "adaptive_std": float(a.std()),
            "adaptive_gain": float(a.mean() / max(s.mean(), 1e-12)),
        }


def link_error_experiment(*, n_iterations: int = 5, error_frac: float = 0.08,
                          degradation: float = 0.9, seed: int = 0) -> ARResult:
    """Fig 12a: 64 nodes (512 GPUs) ring all-reduce under bit-error storms."""
    rng = np.random.default_rng(seed)
    static_bw, adaptive_bw = [], []
    members = list(range(64))
    for it in range(n_iterations):
        t = Torus2D(8, 8)
        t.degrade_links(error_frac, degradation, rng)
        rng.shuffle(members)
        bw_s, _ = ring_allreduce_bandwidth(t, members, static_route)
        bw_a, _ = ring_allreduce_bandwidth(t, members, adaptive_route)
        static_bw.append(bw_s)
        adaptive_bw.append(bw_a)
    return ARResult(static_bw, adaptive_bw)


def contention_experiment(*, n_groups: int = 32, seed: int = 0) -> ARResult:
    """Fig 12b: 32 concurrent 2-node all-reduce rings on 64 healthy nodes."""
    rng = np.random.default_rng(seed)
    t = Torus2D(8, 8)
    perm = rng.permutation(64)
    groups = [perm[2 * i:2 * i + 2].tolist() for i in range(n_groups)]
    static_bw, adaptive_bw = [], []
    for router, sink in ((static_route, static_bw),
                         (adaptive_route, adaptive_bw)):
        load: dict = {}
        bws = []
        for g in groups:
            bw, load = ring_allreduce_bandwidth(t, g, router,
                                                existing_load=load)
            bws.append(bw)
        sink.extend(bws)
    return ARResult(static_bw, adaptive_bw)
