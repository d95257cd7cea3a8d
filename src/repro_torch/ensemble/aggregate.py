"""Deterministic online aggregation of ensemble cell stats into bands.

Cells stream in as workers finish — in whatever order the pool delivers
them — and the aggregator folds each cell's scalars immediately (it never
sees a trace).  Determinism contract: the aggregated bands are a pure
function of the *set* of cells, computed over seed-sorted values, so the
result is bit-identical whether the grid ran on 1 worker or 16 and in
whatever completion order (regression-tested in tests/test_ensemble.py).
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np

from repro_torch.ensemble.runner import CellStats

# per-scale banded metrics (each a CellStats field)
BAND_METRICS = ("ettr_sim", "ettr_model", "ettr_model_nominal",
                "mttf_large_h", "goodput", "fitted_r_f")

_PCTS = (5.0, 25.0, 50.0, 75.0, 95.0)


@dataclass(frozen=True)
class MetricBand:
    """Seed-ensemble band for one metric at one scale."""

    metric: str
    n: int            # cells with a finite value
    mean: float
    std: float
    p5: float
    p25: float
    p50: float
    p75: float
    p95: float
    lo: float         # min
    hi: float         # max

    def contains(self, x: float, *, pad_lo: float = 0.0,
                 pad_hi: float = 0.0) -> bool:
        """Is ``x`` inside the [min, max] band (optionally padded)?"""
        if not (self.n and math.isfinite(x)):
            return False
        return self.lo - pad_lo <= x <= self.hi + pad_hi

    def to_json(self) -> dict:
        return asdict(self)


def _band(metric: str, values: list[float]) -> MetricBand:
    vals = np.array([v for v in values if math.isfinite(v)])
    if not len(vals):
        nan = float("nan")
        return MetricBand(metric, 0, nan, nan, nan, nan, nan, nan, nan,
                          nan, nan)
    pcts = np.percentile(vals, _PCTS)
    return MetricBand(
        metric, int(len(vals)), float(vals.mean()),
        float(vals.std(ddof=1)) if len(vals) > 1 else 0.0,
        *(float(p) for p in pcts), float(vals.min()), float(vals.max()))


class EnsembleAggregator:
    """Folds ``CellStats`` online; serves per-scale metric bands.

    Only scalars are retained (a 16-seed x 3-scale grid is ~50 small
    records) — the traces the cells were scored from never reach the
    aggregating process."""

    def __init__(self):
        self._cells: dict[tuple[int, int], CellStats] = {}

    # -- streaming side -------------------------------------------------
    def add(self, stats: CellStats) -> None:
        key = (stats.n_gpus, stats.seed)
        if key in self._cells:
            raise ValueError(f"duplicate ensemble cell {key}")
        self._cells[key] = stats

    @property
    def n_cells(self) -> int:
        return len(self._cells)

    # -- aggregation side ------------------------------------------------
    def scales(self) -> list[int]:
        return sorted({g for g, _ in self._cells})

    def seeds(self) -> list[int]:
        """Distinct seeds across the grid (the seed axis of the batched
        analytical band grid in ``repro_torch.ensemble.run``)."""
        return sorted({s for _, s in self._cells})

    def cells_at(self, n_gpus: int) -> list[CellStats]:
        """Cells for one scale in seed order (the determinism anchor: any
        completion order collapses to this)."""
        return [self._cells[k] for k in sorted(self._cells)
                if k[0] == n_gpus]

    def bands(self, n_gpus: int) -> dict[str, MetricBand]:
        cells = self.cells_at(n_gpus)
        return {m: _band(m, [getattr(c, m) for c in cells])
                for m in BAND_METRICS}

    def rsc1_cluster_days(self) -> float:
        """Total simulated cluster time in RSC-1 equivalents (2000 nodes x
        8 GPUs == 1.0x) — the numerator of the AIReSim-style
        cluster-days-per-second figure of merit."""
        return sum(c.sim_days * c.n_gpus / 16000.0
                   for c in self._cells.values())

    def attribution(self, n_gpus: int) -> dict[str, float]:
        """Mean fault-mix fraction per symptom across seeds (symptoms
        sorted; absent symptom in a cell counts as 0)."""
        cells = self.cells_at(n_gpus)
        if not cells:
            return {}
        symptoms = sorted({s for c in cells for s in c.attribution})
        return {s: float(np.mean([c.attribution.get(s, 0.0) for c in cells]))
                for s in symptoms}

    def band_table(self) -> str:
        hdr = (f"{'gpus':>6s} {'seeds':>5s} {'metric':20s} {'mean':>9s} "
               f"{'p5':>9s} {'p50':>9s} {'p95':>9s} {'min':>9s} {'max':>9s}")
        lines = [hdr, "-" * len(hdr)]
        for g in self.scales():
            for m, b in self.bands(g).items():
                if not b.n:
                    continue
                lines.append(
                    f"{g:6d} {b.n:5d} {m:20s} {b.mean:9.4g} {b.p5:9.4g} "
                    f"{b.p50:9.4g} {b.p95:9.4g} {b.lo:9.4g} {b.hi:9.4g}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "n_cells": self.n_cells,
            "cells": [self._cells[k].to_json()
                      for k in sorted(self._cells)],
            "scales": {
                str(g): {
                    "bands": {m: b.to_json()
                              for m, b in self.bands(g).items()},
                    "attribution": self.attribution(g),
                } for g in self.scales()
            },
        }


def aggregate(cells, *, aggregator: Optional[EnsembleAggregator] = None
              ) -> EnsembleAggregator:
    """Fold an iterable of ``CellStats`` (any order) into an aggregator."""
    agg = aggregator or EnsembleAggregator()
    for c in cells:
        if c is not None:
            agg.add(c)
    return agg
