"""Analytical E[ETTR] estimator (paper Eq. 1-3 and Appendix A); the port of
``repro.core.ettr_model``.

All times in DAYS internally (matching the paper's r_f units of failures
per node-day); convenience wrappers accept seconds.

  E[ETTR] >= (1 - N r_f (u0 + dt/2))
             / (1 + (u0+q)/R + w/dt + N r_f q (1 + w/dt - dt/(2R)))   (Eq 1)

  long-run, high-priority simplification (q ~ 0):
  E[ETTR] ~ (1 - N r_f (u0 + dt/2)) / (1 + w/dt)                      (Eq 2)

  Daly-Young optimal interval: dt* = sqrt(2 w / (N r_f))              (Eq 3)

The public estimators dispatch through the ``repro_torch.core.backend``
seam: ``backend=None`` keeps the process default (numpy float64, the
authoritative path), ``backend=StatBackend.TORCH`` (or ``"torch"``) routes
to the float32 grid kernel, on the card unless ``device="cpu"`` asks for
its plain version; the numpy path ignores ``device``. See
docs/stat_backend.md for the tolerance policy and ``backend.batch_bands``
for whole-grid calls.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

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


def expected_n_failures(p: ETTRParams, *, backend=None, device=None) -> float:
    """Appendix Eq. 5."""
    from repro_torch.core import backend as _bk

    if _bk.resolve_backend(backend) is _bk.StatBackend.TORCH:
        return _bk.torch_expected_n_failures(p, device=device)
    d = p.resolved_dt_s() / SECONDS_PER_DAY
    u0 = p.u0_s / SECONDS_PER_DAY
    w = p.w_cp_s / SECONDS_PER_DAY
    R = p.runtime_s / SECONDS_PER_DAY
    lam = p.lam
    denom = 1.0 - lam * (u0 + d / 2.0)
    if denom <= 0:
        return float("inf")
    return R * lam * (1.0 + u0 / R + _w_over_dt(w, d)) / denom


def expected_ettr(p: ETTRParams, *, backend=None, device=None) -> float:
    """Eq. 1 (full form, with queue waits)."""
    from repro_torch.core import backend as _bk

    if _bk.resolve_backend(backend) is _bk.StatBackend.TORCH:
        return _bk.torch_expected_ettr(p, device=device)
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


def expected_ettr_simple(p: ETTRParams) -> float:
    """Eq. 2 (long-running, high-priority, q ~ 0)."""
    d = p.resolved_dt_s() / SECONDS_PER_DAY
    u0 = p.u0_s / SECONDS_PER_DAY
    w = p.w_cp_s / SECONDS_PER_DAY
    num = 1.0 - p.lam * (u0 + d / 2.0)
    return max(0.0, min(1.0, num / (1.0 + _w_over_dt(w, d))))


def ettr_contour(
    n_gpus: int = 12_288,
    r_f_grid=None,
    w_cp_grid_s=None,
    *,
    u0_s: float = 300.0,
    runtime_s: float = 7 * 86400.0,
    gpus_per_node: int = 8,
    backend=None,
    device=None,
):
    """Figure 10: E[ETTR] over (failure rate x checkpoint write overhead)
    for a 12k-GPU run with Daly-Young intervals.  Returns (r_f_grid,
    w_cp_grid_s, ettr[len(w), len(r)], dt_opt_s same shape).

    The TORCH backend evaluates the whole contour in one grid call
    instead of the len(w) x len(r) Python loop."""
    from repro_torch.core import backend as _bk

    if r_f_grid is None:
        r_f_grid = np.logspace(np.log10(0.5e-3), np.log10(20e-3), 41)
    if w_cp_grid_s is None:
        w_cp_grid_s = np.logspace(0, np.log10(1200), 41)
    n_nodes = n_gpus // gpus_per_node
    if _bk.resolve_backend(backend) is _bk.StatBackend.TORCH:
        E, DT = _bk.torch_ettr_contour(r_f_grid, w_cp_grid_s,
                                       n_nodes=n_nodes, u0_s=u0_s,
                                       runtime_s=runtime_s, device=device)
        return np.asarray(r_f_grid), np.asarray(w_cp_grid_s), E, DT
    E = np.zeros((len(w_cp_grid_s), len(r_f_grid)))
    DT = np.zeros_like(E)
    for i, w in enumerate(w_cp_grid_s):
        for j, r in enumerate(r_f_grid):
            p = ETTRParams(n_nodes=n_nodes, r_f=r, u0_s=u0_s, w_cp_s=w,
                           runtime_s=runtime_s)
            E[i, j] = expected_ettr(p)
            DT[i, j] = p.resolved_dt_s()
    return np.asarray(r_f_grid), np.asarray(w_cp_grid_s), E, DT


def required_w_cp_for_target(n_gpus: int, target_ettr: float,
                             r_f: float = 6.50e-3, *, u0_s: float = 300.0,
                             gpus_per_node: int = 8) -> float:
    """Smallest checkpoint write overhead (s) achieving target E[ETTR]
    (Daly-Young interval), by bisection.  Paper: ~O(10 s) for 0.9 @ 12k."""
    n_nodes = n_gpus // gpus_per_node

    def e(w):
        return expected_ettr_simple(ETTRParams(
            n_nodes=n_nodes, r_f=r_f, u0_s=u0_s, w_cp_s=w))

    lo, hi = 1e-3, 3600.0
    if e(hi) >= target_ettr:
        return hi
    if e(lo) < target_ettr:
        return float("nan")
    for _ in range(80):
        mid = math.sqrt(lo * hi)
        if e(mid) >= target_ettr:
            lo = mid
        else:
            hi = mid
    return lo
