"""Key reliability metrics (paper §II-D): ETTR, Goodput, MTTF.

A *job run* is a sequence of scheduler jobs belonging to one logical
training task (re-queues after failures/preemptions keep the run alive).
ETTR = productive runtime / available wallclock, where available wallclock
counts scheduled time plus eligible-but-queued time, and productive runtime
excludes (1) lost work since the last checkpoint, (2) restart overhead,
(3) checkpoint write overhead.

Copy of ``repro.core.metrics``: the statistical layer reads its records,
the simulator's scoring its ETTR / goodput / MTTF.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np


class JobState(str, enum.Enum):
    COMPLETED = "COMPLETED"
    CANCELLED = "CANCELLED"
    FAILED = "FAILED"
    NODE_FAIL = "NODE_FAIL"
    OUT_OF_MEMORY = "OUT_OF_MEMORY"
    PREEMPTED = "PREEMPTED"
    REQUEUED = "REQUEUED"
    TIMEOUT = "TIMEOUT"


@dataclass(slots=True)
class JobRecord:
    """One scheduler job (one attempt of a run).

    ``slots=True``: a paper-scale replay holds millions of these at once.
    """

    job_id: int
    run_id: int
    n_gpus: int
    submit_t: float     # eligible-to-schedule time
    start_t: float
    end_t: float
    state: JobState
    priority: int = 0
    hw_attributed: bool = False       # critical health check fired near end
    symptoms: tuple = ()
    preempted_by: Optional[int] = None

    @property
    def queue_time(self) -> float:
        return max(self.start_t - self.submit_t, 0.0)

    @property
    def run_time(self) -> float:
        return max(self.end_t - self.start_t, 0.0)

    @property
    def n_nodes(self) -> int:
        return max(1, (self.n_gpus + 7) // 8)


@dataclass
class RunETTR:
    ettr: float
    productive: float
    wallclock: float
    queue: float
    unproductive: float
    n_interruptions: int


def job_run_ettr(
    jobs: list[JobRecord],
    *,
    checkpoint_interval: Optional[float] = None,  # seconds; None = Daly-Young
    w_cp: float = 300.0,   # checkpoint write overhead (s)
    u0: float = 300.0,     # restart/init overhead (s)
    r_f_per_node_day: float = 6.50e-3,
) -> RunETTR:
    """Estimate ETTR for a job run from scheduler records.

    Mirrors the paper's estimation: every job that does not end COMPLETED is
    treated as an interruption; each interruption costs (u0 + lost work
    since last checkpoint); every job pays w_cp per checkpoint interval.
    """
    jobs = sorted(jobs, key=lambda j: j.submit_t)
    if not jobs:
        return RunETTR(0.0, 0.0, 0.0, 0.0, 0.0, 0)
    n_nodes = jobs[0].n_nodes
    if checkpoint_interval is None:
        lam = n_nodes * r_f_per_node_day / 86400.0  # failures per second
        checkpoint_interval = float(np.sqrt(2.0 * w_cp / max(lam, 1e-12)))

    queue = sum(j.queue_time for j in jobs)
    scheduled = sum(j.run_time for j in jobs)
    n_int = sum(1 for j in jobs if j.state != JobState.COMPLETED)

    unproductive = 0.0
    for j in jobs:
        # checkpoint write overhead amortized over the job's runtime
        n_cp = j.run_time / max(checkpoint_interval, 1e-9)
        over = n_cp * w_cp + u0
        if j.state != JobState.COMPLETED:
            over += min(checkpoint_interval / 2.0, j.run_time)  # lost work
        unproductive += min(over, j.run_time)

    productive = max(scheduled - unproductive, 0.0)
    wallclock = queue + scheduled
    ettr = productive / wallclock if wallclock > 0 else 0.0
    return RunETTR(ettr, productive, wallclock, queue, unproductive, n_int)


# ---------------------------------------------------------------------------
# MTTF
# ---------------------------------------------------------------------------
def mttf(total_time: float, n_failures: int) -> float:
    """Mean time to failure; inf when no failures observed."""
    if n_failures <= 0:
        return float("inf")
    return total_time / n_failures


def is_infra_failure(j: JobRecord) -> bool:
    """NODE_FAIL, or FAILED with a critical health check attributed (the
    paper's infra-failure definition for the MTTF/ETTR analyses)."""
    return j.state == JobState.NODE_FAIL or (
        j.state == JobState.FAILED and j.hw_attributed)


def mttf_by_job_size(
    jobs: Iterable[JobRecord],
    *,
    failure_pred=is_infra_failure,
    size_round: int = 8,
) -> dict[int, tuple[float, int]]:
    """(total runtime, #failures) per job-size bucket (GPUs, rounded up to
    the next multiple of ``size_round``), as in Figure 7."""
    acc: dict[int, list[float]] = {}
    for j in jobs:
        size = max(size_round, int(np.ceil(j.n_gpus / size_round)) * size_round)
        ent = acc.setdefault(size, [0.0, 0])
        ent[0] += j.run_time
        if failure_pred(j):
            ent[1] += 1
    return {k: (v[0], int(v[1])) for k, v in sorted(acc.items())}


# ---------------------------------------------------------------------------
# Goodput
# ---------------------------------------------------------------------------
@dataclass
class GoodputLoss:
    failure_loss_gpu_s: float = 0.0       # first-order: failed jobs' lost work
    preemption_loss_gpu_s: float = 0.0    # second-order: preempted victims
    checkpoint_loss_gpu_s: float = 0.0    # checkpoint write overhead
    queue_loss_gpu_s: float = 0.0


def goodput_loss(
    jobs: list[JobRecord],
    *,
    assumed_cp_interval: float = 3600.0,
    failure_states=(JobState.FAILED, JobState.NODE_FAIL),
) -> GoodputLoss:
    """Paper Fig. 8 accounting: hourly checkpoints -> each failure loses
    min(runtime, 30 min) x GPUs; preemptions triggered by failed jobs lose
    the same bound."""
    out = GoodputLoss()
    for j in jobs:
        lost = min(j.run_time, assumed_cp_interval / 2.0) * j.n_gpus
        if j.state in failure_states:
            out.failure_loss_gpu_s += lost
        elif j.state == JobState.PREEMPTED and j.preempted_by is not None:
            out.preemption_loss_gpu_s += lost
        out.queue_loss_gpu_s += j.queue_time * j.n_gpus
    return out


def cluster_utilization(jobs: list[JobRecord], n_gpus_total: int,
                        t0: float, t1: float) -> float:
    used = sum(
        max(0.0, min(j.end_t, t1) - max(j.start_t, t0)) * j.n_gpus
        for j in jobs)
    return used / max((t1 - t0) * n_gpus_total, 1e-9)
