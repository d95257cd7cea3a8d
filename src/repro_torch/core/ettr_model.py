"""Analytical E[ETTR] estimator (paper Eq. 1-3 and Appendix A); the numpy
path of ``repro.core.ettr_model``, copied.

All times in DAYS internally (matching the paper's r_f units of failures
per node-day); convenience wrappers accept seconds.

  E[ETTR] >= (1 - N r_f (u0 + dt/2))
             / (1 + (u0+q)/R + w/dt + N r_f q (1 + w/dt - dt/(2R)))   (Eq 1)

  Daly-Young optimal interval: dt* = sqrt(2 w / (N r_f))              (Eq 3)
"""
from __future__ import annotations

import math
from dataclasses import dataclass

SECONDS_PER_DAY = 86400.0


@dataclass(frozen=True)
class ETTRParams:
    n_nodes: int
    r_f: float = 6.50e-3        # failures per node-day
    u0_s: float = 300.0         # restart/init overhead (s)
    w_cp_s: float = 300.0       # synchronous checkpoint write cost (s)
    q_s: float = 0.0            # expected queue wait per (re)submission (s)
    runtime_s: float = 7 * 86400.0  # productive runtime R of the run (s)
    dt_cp_s: float = 0.0        # checkpoint interval; 0 -> Daly-Young optimal

    @property
    def lam(self) -> float:
        """Job-level failure rate, failures per day."""
        return self.n_nodes * self.r_f

    def resolved_dt_s(self) -> float:
        """Checkpoint interval: explicit ``dt_cp_s`` if set, else the
        Daly-Young optimum (0 when checkpoints are free, w_cp_s = 0)."""
        if self.w_cp_s < 0:
            raise ValueError(f"w_cp_s must be >= 0, got {self.w_cp_s}")
        if self.dt_cp_s > 0:
            return self.dt_cp_s
        return daly_young_interval_s(self.n_nodes, self.r_f, self.w_cp_s)


def daly_young_interval_s(n_nodes: int, r_f: float, w_cp_s: float) -> float:
    """Eq. 3: dt* = sqrt(2 w_cp / (N r_f)); result in seconds."""
    lam_per_s = n_nodes * r_f / SECONDS_PER_DAY
    return math.sqrt(2.0 * w_cp_s / max(lam_per_s, 1e-18))


def _w_over_dt(w: float, d: float) -> float:
    """``w/dt`` with the free-checkpoint limit: w_cp=0 drives the
    Daly-Young dt to 0 and the overhead ratio to 0, not to a 0/0 blowup."""
    return w / d if d > 0 else 0.0


def expected_n_failures(p: ETTRParams) -> float:
    """Appendix Eq. 5."""
    d = p.resolved_dt_s() / SECONDS_PER_DAY
    u0 = p.u0_s / SECONDS_PER_DAY
    w = p.w_cp_s / SECONDS_PER_DAY
    R = p.runtime_s / SECONDS_PER_DAY
    lam = p.lam
    denom = 1.0 - lam * (u0 + d / 2.0)
    if denom <= 0:
        return float("inf")
    return R * lam * (1.0 + u0 / R + _w_over_dt(w, d)) / denom


def expected_ettr(p: ETTRParams) -> float:
    """Eq. 1 (full form, with queue waits)."""
    d = p.resolved_dt_s() / SECONDS_PER_DAY
    u0 = p.u0_s / SECONDS_PER_DAY
    w = p.w_cp_s / SECONDS_PER_DAY
    q = p.q_s / SECONDS_PER_DAY
    R = p.runtime_s / SECONDS_PER_DAY
    lam = p.lam
    num = 1.0 - lam * (u0 + d / 2.0)
    if num <= 0:
        return 0.0
    w_d = _w_over_dt(w, d)
    den = (1.0 + (u0 + q) / R + w_d
           + lam * q * (1.0 + w_d - d / (2.0 * R)))
    return max(0.0, min(1.0, num / den))
