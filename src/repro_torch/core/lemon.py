"""Lemon-node detection (paper §IV-A, Figure 11, Table II); copy of
``repro.core.lemon``.

Lemon nodes cause repeated job failures but evade point-in-time health
checks; the paper's detector aggregates 28 days of per-node history over
seven signals and flags nodes exceeding manually tuned thresholds.
Reported outcome: 40 nodes flagged across RSC-1/2 (1.2% / 1.7% of fleet),
>85% precision, and large-job (512+ GPU) failure rate dropping 14% -> 4%.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

# Table II: observed root causes of confirmed lemons.
LEMON_ROOT_CAUSES = {
    "GPU": 0.282, "DIMM": 0.205, "PCIE": 0.154, "EUD": 0.103, "NIC": 0.077,
    "BIOS": 0.077, "PSU": 0.051, "Optics": 0.026, "CPU": 0.026,
}

SIGNALS = (
    "excl_jobid_count",          # distinct jobs that excluded this node
    "xid_cnt",                   # unique XID errors seen
    "tickets",                   # repair tickets filed
    "out_count",                 # times taken out of scheduling
    "multi_node_node_fails",     # multi-node job failures caused
    "single_node_node_fails",    # single-node job failures caused
    "single_node_node_failure_rate",
)


@dataclass
class NodeHistory:
    node_id: int
    window_days: float = 28.0
    excl_jobid_count: int = 0
    xid_cnt: int = 0
    tickets: int = 0
    out_count: int = 0
    multi_node_node_fails: int = 0
    single_node_node_fails: int = 0
    single_node_jobs: int = 0

    @property
    def single_node_node_failure_rate(self) -> float:
        if self.single_node_jobs == 0:
            return 0.0
        return self.single_node_node_fails / self.single_node_jobs

    def signal(self, name: str) -> float:
        return float(getattr(self, name))


@dataclass(frozen=True)
class LemonThresholds:
    """Manually tuned per-signal thresholds (paper: tuned on a 28-day
    snapshot for accuracy and false-positive rate).  A node is a lemon
    candidate when at least ``min_signals`` signals trip.

    Note: the paper found excl_jobid_count weakly correlated with true
    node failures (users over-exclude), so its threshold is high and it
    never suffices alone.
    """

    excl_jobid_count: float = 8.0
    xid_cnt: float = 4.0
    tickets: float = 2.0
    out_count: float = 3.0
    multi_node_node_fails: float = 3.0
    single_node_node_fails: float = 2.0
    single_node_node_failure_rate: float = 0.5
    min_signals: int = 2


@dataclass
class LemonVerdict:
    node_id: int
    is_lemon: bool
    tripped: tuple[str, ...]
    score: int


class LemonDetector:
    def __init__(self, thresholds: Optional[LemonThresholds] = None):
        self.thresholds = thresholds or LemonThresholds()

    def evaluate(self, hist: NodeHistory) -> LemonVerdict:
        th = self.thresholds
        tripped = []
        for s in SIGNALS:
            if hist.signal(s) >= getattr(th, s):
                # excl_jobid_count alone is a weak signal (paper Fig. 11)
                tripped.append(s)
        strong = [s for s in tripped if s != "excl_jobid_count"]
        is_lemon = (len(tripped) >= th.min_signals and len(strong) >= 1)
        return LemonVerdict(hist.node_id, is_lemon, tuple(tripped),
                            len(tripped))

    def scan(self, histories: Iterable[NodeHistory]) -> list[LemonVerdict]:
        return [self.evaluate(h) for h in histories]


def detection_quality(verdicts: list[LemonVerdict],
                      true_lemons: set[int]) -> dict:
    flagged = {v.node_id for v in verdicts if v.is_lemon}
    tp = len(flagged & true_lemons)
    fp = len(flagged - true_lemons)
    fn = len(true_lemons - flagged)
    precision = tp / max(len(flagged), 1)
    recall = tp / max(len(true_lemons), 1)
    return {"flagged": len(flagged), "tp": tp, "fp": fp, "fn": fn,
            "precision": precision, "recall": recall}
