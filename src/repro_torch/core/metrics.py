"""Job records and the MTTF bookkeeping ``mttf_model`` needs (paper
§II-D); the part of ``repro.core.metrics`` that the statistical layer
reads, copied: ``JobState``, ``JobRecord``, ``is_infra_failure`` and
``mttf_by_job_size``.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
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
