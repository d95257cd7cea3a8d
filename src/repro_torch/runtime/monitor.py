"""Runtime monitors: straggler detection + collective flight recorder (copy
of ``repro.runtime.monitor``).

Straggler detection (paper §V): per-step wall times per node; a node whose
step times exceed ``threshold x`` the fleet median for ``patience``
consecutive steps is flagged for replacement.

Collective flight recorder (paper §V Debugging Tools): logs which ranks
entered/exited each collective; on a timeout, the first collective with a
non-full entry set identifies the culprit ranks — the paper's NCCL-timeout
root-causing method, reimplemented for the single-controller runtime's
simulated multi-host mode.

Both monitors expose ``as_metric_source()`` — a zero-argument poll
returning a flat dict — for a live dashboard (the reference's
``MetricsRegistry.add_source``).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class StragglerMonitor:
    n_nodes: int
    threshold: float = 1.8
    patience: int = 3
    history: dict = field(default_factory=lambda: defaultdict(list))
    _strikes: dict = field(default_factory=lambda: defaultdict(int))
    flagged: set = field(default_factory=set)

    def observe(self, step: int, node_times: dict[int, float]) -> set:
        med = float(np.median(list(node_times.values())))
        newly = set()
        for node, t in node_times.items():
            self.history[node].append(t)
            if med > 0 and t > self.threshold * med:
                self._strikes[node] += 1
                if self._strikes[node] >= self.patience \
                        and node not in self.flagged:
                    self.flagged.add(node)
                    newly.add(node)
            else:
                self._strikes[node] = 0
        return newly

    def as_metric_source(self):
        """Zero-arg poll for ``MetricsRegistry.add_source``: flagged
        count, nodes currently on >=1 strike, and steps observed."""
        def poll() -> dict:
            return {
                "n_flagged": len(self.flagged),
                "flagged": sorted(self.flagged),
                "n_striking": sum(1 for s in self._strikes.values()
                                  if s > 0),
                "n_steps": max((len(h) for h in self.history.values()),
                               default=0),
            }
        return poll


@dataclass
class CollectiveTracer:
    n_ranks: int
    entries: dict = field(default_factory=lambda: defaultdict(set))
    exits: dict = field(default_factory=lambda: defaultdict(set))
    order: list = field(default_factory=list)

    def enter(self, coll_id: str, rank: int) -> None:
        if coll_id not in self.entries:
            self.order.append(coll_id)
        self.entries[coll_id].add(rank)

    def exit(self, coll_id: str, rank: int) -> None:
        self.exits[coll_id].add(rank)

    def diagnose(self) -> Optional[dict]:
        """First collective where some ranks never arrived (deadlock root
        cause), or where all arrived but some never left (network/HW)."""
        all_ranks = set(range(self.n_ranks))
        for cid in self.order:
            missing = all_ranks - self.entries[cid]
            if missing:
                return {"collective": cid, "kind": "missing_entry",
                        "culprit_ranks": sorted(missing)}
        for cid in self.order:
            stuck = self.entries[cid] - self.exits[cid]
            if stuck and self.entries[cid] == all_ranks:
                return {"collective": cid, "kind": "stuck_inside",
                        "culprit_ranks": sorted(stuck)}
        return None

    def as_metric_source(self):
        """Zero-arg poll for ``MetricsRegistry.add_source``: collective
        counts plus the current diagnosis (flattened; None fields when
        healthy)."""
        def poll() -> dict:
            d = self.diagnose()
            return {
                "n_collectives": len(self.order),
                "diagnosis_kind": None if d is None else d["kind"],
                "culprit_ranks": [] if d is None else d["culprit_ranks"],
            }
        return poll
