"""MTTF failure model (paper §III, Figure 7).

Empirically, job MTTF shrinks inversely with allocated nodes:
MTTF = (N_nodes * r_f)^-1, with r_f the cluster failure rate in failures
per node-day.  The paper's calibration:

  RSC-1: r_f = 6.50 failures / 1000 node-days
  RSC-2: r_f = 2.34 failures / 1000 node-days

Projections (RSC-1): 16,384 GPUs -> 1.8 h;  131,072 GPUs -> 0.23 h.
These are asserted by benchmarks/fig7_mttf.py. The port of
``repro.core.mttf_model``: ``backend="torch"`` computes on the card unless
``device="cpu"`` asks for the plain version (the numpy path ignores
``device``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from repro_torch.core import stats
from repro_torch.core.metrics import JobRecord, JobState, mttf_by_job_size

GPUS_PER_NODE = 8

# Paper-calibrated cluster failure rates (failures per node-day).
R_F = {"RSC-1": 6.50e-3, "RSC-2": 2.34e-3}


@dataclass(frozen=True)
class MTTFPoint:
    n_gpus: int
    mttf_hours: float
    ci_lo_hours: float
    ci_hi_hours: float
    n_failures: int
    node_days: float


def projected_mttf_hours(n_gpus: int, r_f_per_node_day: float, *,
                         backend=None, device=None) -> float:
    """Theory line: MTTF = (N_nodes * r_f)^-1, in hours."""
    from repro_torch.core import backend as _bk

    if _bk.resolve_backend(backend) is _bk.StatBackend.TORCH:
        return _bk.torch_projected_mttf_hours(n_gpus, r_f_per_node_day,
                                              device=device)
    n_nodes = max(1, n_gpus // GPUS_PER_NODE)
    return 24.0 / (n_nodes * r_f_per_node_day)


def _failure_mask(j: JobRecord, require_hw_attribution: bool) -> bool:
    """Paper §III failure predicate shared by both fit_r_f backends."""
    if j.state == JobState.NODE_FAIL:
        return True
    return j.state == JobState.FAILED and (
        j.hw_attributed or not require_hw_attribution)


def fit_r_f(jobs: Iterable[JobRecord], *, min_gpus: int = 128,
            failure_states=(JobState.NODE_FAIL,),
            require_hw_attribution: bool = True,
            backend=None, device=None) -> float:
    """Cluster failure rate from job records (paper method: NODE_FAIL jobs
    plus FAILED jobs with an attributable critical health check, over all
    jobs > ``min_gpus``; divided by node-days of runtime)."""
    from repro_torch.core import backend as _bk

    if _bk.resolve_backend(backend) is _bk.StatBackend.TORCH:
        jobs = list(jobs)
        return _bk.torch_fit_r_f(
            np.array([j.n_gpus for j in jobs], dtype=np.float64),
            np.array([j.n_nodes for j in jobs], dtype=np.float64),
            np.array([j.run_time for j in jobs], dtype=np.float64),
            np.array([_failure_mask(j, require_hw_attribution)
                      for j in jobs], dtype=bool),
            min_gpus=min_gpus, device=device)
    node_days = 0.0
    failures = 0
    for j in jobs:
        if j.n_gpus <= min_gpus:
            continue
        node_days += j.n_nodes * j.run_time / 86400.0
        if _failure_mask(j, require_hw_attribution):
            failures += 1
    if node_days <= 0:
        return float("nan")
    return failures / node_days


def empirical_mttf_curve(
    jobs: list[JobRecord],
    *,
    conf: float = 0.90,
    failure_pred=None,
) -> list[MTTFPoint]:
    """Figure 7: per-job-size MTTF with Gamma CIs."""
    from repro_torch.core.metrics import is_infra_failure

    out = []
    for size, (runtime_s, n_fail) in mttf_by_job_size(
            jobs, failure_pred=failure_pred or is_infra_failure).items():
        hours = runtime_s / 3600.0
        m = hours / n_fail if n_fail else float("inf")
        lo, hi = stats.mttf_ci(n_fail, hours, conf)
        out.append(MTTFPoint(size, m, lo, hi, n_fail,
                             runtime_s / 86400.0 * size / GPUS_PER_NODE))
    return out


def projection_table(r_f_per_node_day: float,
                     gpu_scales=(1024, 2048, 4096, 8192, 16384, 32768,
                                 65536, 131072)) -> dict[int, float]:
    return {g: projected_mttf_hours(g, r_f_per_node_day) for g in gpu_scales}
