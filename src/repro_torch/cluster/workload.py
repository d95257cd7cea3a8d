"""Workload generator calibrated to the paper's published aggregates.

Figure 6 / Observation 7 (job-size mix and GPU-time shares), §II-A
(7.2k / 4.4k jobs per day, 83% / 85% utilization), Figure 3 (job status
mix).  Mean durations are *derived* from (job fraction, GPU-time share)
pairs so the Fig. 6 curves hold by construction; tests assert the derived
workload reproduces the paper's headline properties.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class ClusterSpec:
    name: str
    n_nodes: int
    gpus_per_node: int = 8
    jobs_per_day: float = 7200.0
    target_utilization: float = 0.83
    # failure rate (failures per node-day) for the hardware fault process
    r_f: float = 6.50e-3
    lemon_fraction: float = 0.012
    lemon_rate_multiplier: float = 25.0
    # drop mix entries larger than this from the workload (None = keep the
    # full paper mix).  Scale sweeps set it to the cluster's GPU count so a
    # 512-GPU what-if cluster is not poisoned by permanently unschedulable
    # 4096-GPU arrivals hammering the preemption path every pass.
    max_job_gpus: Optional[int] = None

    @property
    def n_gpus(self) -> int:
        return self.n_nodes * self.gpus_per_node


# job-size mix: size -> (fraction of jobs, share of GPU time)
RSC1_MIX: dict[int, tuple[float, float]] = {
    1: (0.44, 0.03), 2: (0.10, 0.01), 4: (0.08, 0.02), 8: (0.28, 0.04),
    16: (0.030, 0.02), 32: (0.020, 0.03), 64: (0.015, 0.04),
    128: (0.012, 0.06), 256: (0.009, 0.09), 512: (0.007, 0.15),
    1024: (0.004, 0.18), 2048: (0.0015, 0.12), 4096: (0.0015, 0.12),
}
RSC2_MIX: dict[int, tuple[float, float]] = {
    1: (0.60, 0.12), 2: (0.08, 0.03), 4: (0.06, 0.04), 8: (0.18, 0.09),
    16: (0.020, 0.03), 32: (0.015, 0.04), 64: (0.012, 0.05),
    128: (0.012, 0.08), 256: (0.011, 0.17), 512: (0.006, 0.19),
    1024: (0.004, 0.16),
}

RSC1 = ClusterSpec("RSC-1", n_nodes=2000, jobs_per_day=7200.0,
                   target_utilization=0.83, r_f=6.50e-3,
                   lemon_fraction=0.012)
RSC2 = ClusterSpec("RSC-2", n_nodes=1000, jobs_per_day=4400.0,
                   target_utilization=0.85, r_f=2.34e-3,
                   lemon_fraction=0.017)

MIXES = {"RSC-1": RSC1_MIX, "RSC-2": RSC2_MIX}


@dataclass(slots=True)
class JobRequest:
    """One arrival plus its run-lifecycle state (``slots=True``: the event
    loop materializes one per arrival and requeued runs keep theirs alive
    for the whole horizon).

    Hot-path v3 fused the scheduler's per-run ``RunState`` wrapper into
    the request itself — they were 1:1 for the run's whole lifetime, so
    the split cost one extra allocation per arrival and a ``.request``
    indirection on every hot attribute chain.  ``remaining_s`` /
    ``attempts`` / ``productive_s`` are owned by the scheduler; the
    ``request`` property keeps the v2 ``run.request.<field>`` shape
    working for policies and external callers."""

    job_id: int
    run_id: int
    submit_t: float
    n_gpus: int
    duration_s: float          # natural productive duration if undisturbed
    priority: int
    outcome: str               # natural terminal state: COMPLETED|FAILED|...
    max_lifetime_s: float = 7 * 86400.0
    remaining_s: float = 0.0   # productive seconds still owed (scheduler)
    attempts: int = 0          # requeue count (scheduler)
    productive_s: float = 0.0  # productive seconds banked (scheduler)

    @property
    def n_nodes(self) -> int:
        return max(1, -(-self.n_gpus // 8))

    @property
    def request(self) -> "JobRequest":
        """v2 compatibility: the run state and the request are one."""
        return self


@dataclass
class WorkloadArrays:
    """Column-oriented batch of arrivals (time-sorted).

    The event loop consumes these directly and materializes `JobRequest`
    objects lazily, one at a time, so a paper-scale replay (~2.4M jobs)
    never holds millions of request objects at once.  Outcomes are
    int-coded (``outcome_code`` indexes ``OUTCOME_STRS``): the string
    column cost ~52 B/row as ``<U13`` numpy plus a fresh str object per
    row on ``tolist()`` — the codes decode to *shared* interned strings.
    """

    submit_t: np.ndarray     # float64, sorted ascending
    n_gpus: np.ndarray       # int64
    duration_s: np.ndarray   # float64
    priority: np.ndarray     # int64
    outcome_code: np.ndarray  # int8 index into OUTCOME_STRS
    start_job_id: int = 0

    def __len__(self) -> int:
        return len(self.submit_t)

    @property
    def outcome(self) -> np.ndarray:
        """Decoded outcome labels (materialized on demand)."""
        return np.array(OUTCOME_STRS, dtype=np.str_)[self.outcome_code]

    def request(self, i: int) -> JobRequest:
        jid = self.start_job_id + i
        return JobRequest(
            job_id=jid, run_id=jid, submit_t=float(self.submit_t[i]),
            n_gpus=int(self.n_gpus[i]), duration_s=float(self.duration_s[i]),
            priority=int(self.priority[i]),
            outcome=OUTCOME_STRS[int(self.outcome_code[i])])


# Natural terminal state if infra doesn't kill the job first, calibrated to
# Figure 3 (RSC-1: 60% completed, 24% failed [user], 10% preempted, 2%
# requeued, 0.6% timeout, 0.1% OOM...).  Preempted/requeued/node-fail states
# emerge from the simulation itself, so natural outcomes re-normalize over
# {completed, failed, oom, cancelled, timeout}; cumulative thresholds for
# one uniform draw per job.
_OUTCOMES = np.array(["COMPLETED", "FAILED", "OUT_OF_MEMORY", "CANCELLED",
                      "TIMEOUT"])
OUTCOME_STRS: tuple[str, ...] = tuple(_OUTCOMES.tolist())
_OUTCOME_CUM = np.cumsum([0.66, 0.27, 0.002, 0.06])

# lognormal duration shape: heavy tail, capped at the 7-day lifetime limit
DURATION_SIGMA = 1.2

# spill-mode arrival generation block (rows per part file)
ARRIVAL_BLOCK_ROWS = 131072


class WorkloadGenerator:
    """Poisson arrivals; sizes/durations calibrated per cluster."""

    def __init__(self, spec: ClusterSpec, seed: int = 0):
        self.spec = spec
        mix = MIXES[spec.name]
        if spec.max_job_gpus is not None:
            mix = {s: v for s, v in mix.items() if s <= spec.max_job_gpus}
            if not mix:
                raise ValueError(
                    f"max_job_gpus={spec.max_job_gpus} excludes every "
                    f"{spec.name} mix entry")
        self.mix = mix
        self.rng = np.random.default_rng(seed)
        sizes = np.array(list(self.mix.keys()))
        fracs = np.array([v[0] for v in self.mix.values()])
        shares = np.array([v[1] for v in self.mix.values()])
        fracs = fracs / fracs.sum()
        shares = shares / shares.sum()
        # mean GPU-hours per job so the cluster reaches target utilization
        daily_gpu_h = spec.n_gpus * 24.0 * spec.target_utilization
        k_gpu_h = daily_gpu_h / spec.jobs_per_day
        mean_dur_h = shares * k_gpu_h / (fracs * sizes)
        self.sizes = sizes
        self.fracs = fracs
        self.mean_dur_s = np.minimum(mean_dur_h * 3600.0, 6.5 * 86400.0)

    def generate_arrays(self, horizon_days: float, start_job_id: int = 0
                        ) -> WorkloadArrays:
        """Vectorized arrival generation: one batched Poisson/choice/lognormal
        draw for every job in the horizon instead of a Python loop per job."""
        rate = self.spec.jobs_per_day / 86400.0
        horizon_s = horizon_days * 86400.0
        expected = rate * horizon_s
        # draw inter-arrival gaps in bulk; top up in the (rare) case the
        # first block undershoots the horizon
        n_guess = int(expected + 4.0 * np.sqrt(expected) + 16.0)
        parts = []
        total = 0.0
        while True:
            gaps = self.rng.exponential(1.0 / rate, size=n_guess)
            block = np.cumsum(gaps) + total
            parts.append(block)
            total = float(block[-1])
            if total >= horizon_s:
                break
            n_guess = max(64, int((horizon_s - total) * rate * 1.2) + 16)
        t = np.concatenate(parts) if len(parts) > 1 else parts[0]
        t = t[t < horizon_s]
        n = len(t)

        idx = self.rng.choice(len(self.sizes), size=n, p=self.fracs)
        sizes = self.sizes[idx]
        sigma = DURATION_SIGMA
        mu = np.log(self.mean_dur_s[idx]) - sigma ** 2 / 2.0
        dur = np.clip(self.rng.lognormal(mu, sigma), 30.0, 6.9 * 86400.0)
        # larger jobs run at higher priority (paper §III Preemptions)
        prio = np.where(sizes > 1, np.log2(sizes).astype(np.int64), 0) \
            + self.rng.integers(0, 2, size=n)
        outcome_code = np.searchsorted(
            _OUTCOME_CUM, self.rng.random(n), side="right").astype(np.int8)
        return WorkloadArrays(t, sizes, dur, prio, outcome_code,
                              start_job_id)

    def spill_arrival_blocks(self, horizon_days: float, spill_dir: str,
                             block_rows: int = ARRIVAL_BLOCK_ROWS
                             ) -> list[tuple[str, int]]:
        """Generate the horizon's arrivals in ``block_rows`` blocks and
        write each as an npz part under ``spill_dir`` (constant-RSS mode:
        a 330-day RSC-1 horizon never holds more than ~one block of
        arrival data in RAM).

        **Bit-identical to** ``generate_arrays``: numpy ``Generator``
        distributions consume the underlying bit stream one variate at a
        time, so splitting a size-n draw into consecutive smaller draws
        yields the exact same values (the property
        ``FaultProcess._take_std_exponentials`` already relies on;
        regression-tested in tests/test_sim_perf.py), and the arrival
        cumsum is continued across blocks with an exact running-carry so
        every float matches the one-shot ``np.cumsum(gaps) + total``.
        Returns ``[(part_path, rows), ...]`` in consumption order; parts
        hold compact dtypes (i2 sizes, i1 priority/outcome) that decode
        to the identical scalar values.
        """
        import os

        rate = self.spec.jobs_per_day / 86400.0
        horizon_s = horizon_days * 86400.0
        expected = rate * horizon_s
        rng = self.rng
        os.makedirs(spill_dir, exist_ok=True)

        # phase 1 — arrival times: replicate generate_arrays' part/top-up
        # pattern exactly, drawing each part's gaps in split blocks and
        # continuing the raw cumsum with an exact carry; kept times are
        # re-chunked to uniform block_rows buffers and written to disk
        n_guess = int(expected + 4.0 * np.sqrt(expected) + 16.0)
        total = 0.0
        t_parts: list[str] = []
        part_rows: list[int] = []
        buf: list[np.ndarray] = []
        buf_n = 0

        def _flush_t(final: bool = False) -> None:
            nonlocal buf, buf_n
            while buf_n >= block_rows or (final and buf_n > 0):
                take = min(buf_n, block_rows)
                merged = np.concatenate(buf) if len(buf) > 1 else buf[0]
                chunk, rest = merged[:take], merged[take:]
                path = os.path.join(
                    spill_dir, f"workload-t-{len(t_parts):05d}.npy")
                np.save(path, chunk)
                t_parts.append(path)
                part_rows.append(take)
                buf = [rest] if len(rest) else []
                buf_n = len(rest)

        while True:
            carry = 0.0
            remaining = n_guess
            while remaining > 0:
                b = min(remaining, block_rows)
                gaps = rng.exponential(1.0 / rate, size=b)
                s = np.cumsum(np.concatenate(([carry], gaps)))
                carry = float(s[-1])
                block = s[1:] + total
                kept = block[block < horizon_s]
                if len(kept):
                    buf.append(kept)
                    buf_n += len(kept)
                    _flush_t()
                remaining -= b
            total = carry + total   # same single add as float(block[-1])
            if total >= horizon_s:
                break
            n_guess = max(64, int((horizon_s - total) * rate * 1.2) + 16)
        _flush_t(final=True)

        # phases 2-5 — per-arrival draws, each phase over the full n in
        # split blocks (bulk draw order preserved: all sizes, then all
        # durations, then priorities, then outcomes)
        sigma = DURATION_SIGMA
        sizes_paths = []
        for i, m in enumerate(part_rows):
            idx = rng.choice(len(self.sizes), size=m, p=self.fracs)
            path = os.path.join(spill_dir, f"workload-gpus-{i:05d}.npy")
            np.save(path, self.sizes[idx].astype(np.int16))
            sizes_paths.append(path)
        for i, (m, sp) in enumerate(zip(part_rows, sizes_paths)):
            sizes = np.load(sp)
            idx = np.searchsorted(self.sizes, sizes)   # sizes are unique
            mu = np.log(self.mean_dur_s[idx]) - sigma ** 2 / 2.0
            dur = np.clip(rng.lognormal(mu, sigma), 30.0, 6.9 * 86400.0)
            np.save(os.path.join(spill_dir, f"workload-dur-{i:05d}.npy"),
                    dur)
        for i, (m, sp) in enumerate(zip(part_rows, sizes_paths)):
            sizes = np.load(sp)
            prio = np.where(sizes > 1, np.log2(sizes).astype(np.int64), 0) \
                + rng.integers(0, 2, size=m)
            np.save(os.path.join(spill_dir, f"workload-prio-{i:05d}.npy"),
                    prio.astype(np.int8))
        for i, m in enumerate(part_rows):
            code = np.searchsorted(
                _OUTCOME_CUM, rng.random(m), side="right").astype(np.int8)
            np.save(os.path.join(spill_dir,
                                 f"workload-outcome-{i:05d}.npy"), code)
        return [(os.path.join(spill_dir, f"workload-{{col}}-{i:05d}.npy"),
                 m) for i, m in enumerate(part_rows)]

    def generate(self, horizon_days: float, start_job_id: int = 0
                 ) -> list[JobRequest]:
        arr = self.generate_arrays(horizon_days, start_job_id)
        return [arr.request(i) for i in range(len(arr))]
