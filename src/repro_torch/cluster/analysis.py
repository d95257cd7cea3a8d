"""Figure-oriented summaries over cluster traces (paper §III).

Every metric here computes from a *trace* — the workload-agnostic record
of job attempts and faults defined by ``repro_torch.trace.schema`` — so the
same analysis runs over a live ``ClusterSim``, a saved/ingested
``Trace``, or a plain list of ``JobRecord`` objects.  The in-simulator
path is "record trace -> analyze trace": the trace-derived numbers are
regression-tested exactly equal to the legacy in-engine counters on
identical seeds (tests/test_trace.py).

Input normalization: functions taking job records accept a
``repro_torch.trace.Trace`` (jobs table, materialized via ``job_records()``),
a ``ClusterSim`` (``.records``), or a ``list[JobRecord]``; functions
taking faults likewise accept a ``Trace`` (faults table), a
``ClusterSim`` (``.fault_log``), or a list of fault-like objects.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from repro_torch.core.metrics import (JobRecord, JobState, goodput_loss,
                                      job_run_ettr)


def _job_records(x) -> list[JobRecord]:
    """Normalize a jobs input: ClusterSim -> .records, Trace ->
    .job_records(), anything else is already a record list."""
    recs = getattr(x, "records", None)
    if recs is not None:
        return recs
    materialize = getattr(x, "job_records", None)
    if materialize is not None:
        return materialize()
    return x


def _fault_records(x):
    """Normalize a faults input: ClusterSim -> .fault_log, Trace ->
    .fault_records(), anything else is already a fault list."""
    log = getattr(x, "fault_log", None)
    if log is not None:
        return log
    materialize = getattr(x, "fault_records", None)
    if materialize is not None:
        return materialize()
    return x


# ---------------------------------------------------------------------------
# columnar fast paths (hot-path v3)
#
# The record-object functions below keep their exact sequential-float
# semantics (the trace-vs-counter equality gate in tests/test_trace.py
# compares them bit-for-bit against the legacy counter path), but the
# ensemble/sweep scorer runs thousands of cells and should not
# materialize a JobRecord per row just to sum a column.  These helpers
# compute the scorer's aggregates directly on a trace's jobs table.
# ---------------------------------------------------------------------------
def jobs_run_time(jobs: dict) -> np.ndarray:
    """Per-attempt runtime column: max(end_t - start_t, 0)."""
    return np.maximum(jobs["end_t"] - jobs["start_t"], 0.0)


def infra_failure_mask(jobs: dict) -> np.ndarray:
    """Vectorized ``core.metrics.is_infra_failure``: NODE_FAIL, or FAILED
    with a critical health check attributed."""
    state = jobs["state"]
    return (state == "NODE_FAIL") | ((state == "FAILED")
                                     & jobs["hw_attributed"])


def goodput_loss_columns(jobs: dict, *, assumed_cp_interval: float = 3600.0):
    """Columnar ``core.metrics.goodput_loss`` (same Fig. 8 accounting;
    numpy pairwise sums replace the sequential Python accumulation, so
    values agree to float round-off, not bit-for-bit)."""
    from repro_torch.core.metrics import GoodputLoss
    from repro_torch.trace.schema import NO_JOB

    run_time = jobs_run_time(jobs)
    n_gpus = jobs["n_gpus"]
    state = jobs["state"]
    lost = np.minimum(run_time, assumed_cp_interval / 2.0) * n_gpus
    failed = (state == "FAILED") | (state == "NODE_FAIL")
    second = (state == "PREEMPTED") & (jobs["preempted_by"] != NO_JOB)
    queue_t = np.maximum(jobs["start_t"] - jobs["submit_t"], 0.0)
    return GoodputLoss(
        failure_loss_gpu_s=float(lost[failed].sum()),
        preemption_loss_gpu_s=float(lost[second].sum()),
        queue_loss_gpu_s=float((queue_t * n_gpus).sum()))


def fit_r_f_columns(jobs: dict, *, min_gpus: int = 128) -> float:
    """Columnar ``core.mttf_model.fit_r_f`` (NODE_FAIL plus hw-attributed
    FAILED over node-days of runtime, jobs strictly above ``min_gpus``)."""
    n_gpus = jobs["n_gpus"]
    sel = n_gpus > min_gpus
    if not sel.any():
        return float("nan")
    run_time = jobs_run_time(jobs)[sel]
    n_nodes = np.maximum(1, (n_gpus[sel] + 7) // 8)
    node_days = float((n_nodes * run_time / 86400.0).sum())
    if node_days <= 0:
        return float("nan")
    failures = int(infra_failure_mask(jobs)[sel].sum())
    return failures / node_days


def status_breakdown(records) -> dict[str, dict[str, float]]:
    """Figure 3: share of jobs and of GPU-runtime per terminal state.

    Trace inputs: jobs table (``state``, ``n_gpus``, ``start_t``/``end_t``
    runtime).  Reproduces the paper's headline status mix (RSC-1: ~60%
    COMPLETED / 24% FAILED / 10% CANCELLED by job count, Fig. 3 top) and
    the GPU-time-weighted mix (Fig. 3 bottom)."""
    records = _job_records(records)
    n = len(records)
    gpu_time = sum(r.run_time * r.n_gpus for r in records)
    by_state_jobs = defaultdict(float)
    by_state_time = defaultdict(float)
    for r in records:
        by_state_jobs[r.state.value] += 1
        by_state_time[r.state.value] += r.run_time * r.n_gpus
    return {
        "jobs": {k: v / max(n, 1) for k, v in by_state_jobs.items()},
        "gpu_time": {k: v / max(gpu_time, 1e-9)
                     for k, v in by_state_time.items()},
    }


def hw_impact(records) -> dict[str, float]:
    """Observation 4 (§III): share of jobs / GPU-runtime affected by
    attributed hardware failures.

    Trace inputs: jobs table (``state``, ``hw_attributed``, ``run_id``).
    A job counts as HW-failed when it ended NODE_FAIL, or FAILED with a
    critical health check attributed; "runtime impacted" charges the whole
    GPU-time of every job run touched by a HW event — the paper's <1% of
    jobs vs 19% of runtime asymmetry."""
    records = _job_records(records)
    n = len(records)
    gpu_time = sum(r.run_time * r.n_gpus for r in records)
    hw_jobs = [r for r in records
               if r.state == JobState.NODE_FAIL
               or (r.state == JobState.FAILED and r.hw_attributed)]
    # runtime impacted: the whole run of every job-run touched by a HW event
    impacted_runs = {r.run_id for r in hw_jobs}
    impacted_time = sum(r.run_time * r.n_gpus for r in records
                        if r.run_id in impacted_runs)
    return {
        "hw_job_fraction": len(hw_jobs) / max(n, 1),
        "hw_runtime_fraction": impacted_time / max(gpu_time, 1e-9),
    }


def attribution_rates(records, fault_log=None, n_gpus_total=None,
                      horizon_s=None) -> dict[str, float]:
    """Figure 4: attributed failures per GPU-hour, by Table I symptom.

    Trace inputs: jobs table (``state``, ``symptoms`` taxonomy labels);
    normalization denominators ``n_gpus_total`` / ``horizon_s`` default
    from trace meta (or ClusterSim spec) when omitted.  ``fault_log`` is
    accepted for signature compatibility and ignored — the attributed
    rates count the labels on the jobs a fault actually killed, not raw
    fault events.  The paper's ranking: IB links, filesystem mounts, GPU
    memory errors and PCIe errors dominate (Obs 5)."""
    spec = getattr(records, "spec", None)     # ClusterSim carries a spec
    if n_gpus_total is None:
        n_gpus_total = (spec.n_gpus if spec is not None
                        else getattr(records, "n_gpus", None))
    if horizon_s is None:
        horizon_s = getattr(records, "horizon_s", None)
    if n_gpus_total is None or horizon_s is None:
        raise ValueError("attribution_rates needs n_gpus_total and "
                         "horizon_s (explicit, or from Trace meta / "
                         "ClusterSim spec)")
    records = _job_records(records)
    gpu_hours = n_gpus_total * horizon_s / 3600.0
    counts = defaultdict(int)
    for r in records:
        if r.state in (JobState.NODE_FAIL, JobState.FAILED) and r.symptoms:
            counts[r.symptoms[0]] += 1
    return {k: v / gpu_hours for k, v in
            sorted(counts.items(), key=lambda kv: -kv[1])}


def failure_rate_timeline(fault_log, n_nodes=None, horizon_days=None,
                          window_days: float = 30.0):
    """Figure 5: failures per 1000 node-days, 30-day rolling, per symptom.

    Trace inputs: faults table (``t``, ``symptom``); ``n_nodes`` /
    ``horizon_days`` default from trace meta when ``fault_log`` is a
    ``Trace``.  Returns ``(days, {symptom: rate_series})`` — the paper's
    "failure modes ebb and flow" evolution plot (Obs 6)."""
    spec = getattr(fault_log, "spec", None)   # ClusterSim carries a spec
    if n_nodes is None:
        n_nodes = (spec.n_nodes if spec is not None
                   else getattr(fault_log, "n_nodes", None))
    if horizon_days is None:
        horizon_days = getattr(fault_log, "horizon_days", None)
        if horizon_days is None and spec is not None:
            horizon_days = fault_log.horizon_s / 86400.0
    if n_nodes is None or horizon_days is None:
        raise ValueError("failure_rate_timeline needs n_nodes and "
                         "horizon_days (explicit, or from Trace meta / "
                         "ClusterSim spec)")
    fault_log = _fault_records(fault_log)
    days = np.arange(0, horizon_days, 1.0)
    symptoms = sorted({f.symptom for f in fault_log})
    out = {s: np.zeros(len(days)) for s in symptoms}
    for f in fault_log:
        d = int(f.t / 86400.0)
        if d < len(days):
            out[f.symptom][d] += 1
    rates = {}
    w = int(window_days)
    for s, daily in out.items():
        kernel = np.ones(w) / w
        smoothed = np.convolve(daily, kernel, mode="same")
        rates[s] = smoothed / n_nodes * 1000.0
    return days, rates


def domain_detection_summary(trace) -> dict:
    """Fault-model v2 summary: correlated-domain blast radii and staged
    detection lag, from a trace's optional ``domain`` / ``fault_id`` /
    ``detected_t`` fault columns.

    Returns ``{}`` for v1 traces (columns absent) and for v2 traces that
    recorded neither a domain event nor a positive detection lag, so
    callers can gate a report section on truthiness instead of schema
    version.  Blast size groups nodes by shared ``fault_id`` within
    domain-labeled rows; detection lag is ``detected_t - t`` over rows
    with a resolved detection time (sentinel ``-1.0`` rows are ignored)."""
    has_col = getattr(trace, "has_column", None)
    if has_col is None or not has_col("faults", "domain"):
        return {}
    t = np.asarray(trace.column("faults", "t"), dtype=float)
    if not len(t):
        return {}
    domain = np.asarray(trace.column("faults", "domain"))
    fault_id = np.asarray(trace.column("faults", "fault_id"))
    detected_t = np.asarray(trace.column("faults", "detected_t"),
                            dtype=float)

    out: dict = {}
    dom_mask = domain != ""
    if dom_mask.any():
        kinds = defaultdict(int)
        for d in domain[dom_mask].tolist():
            kinds[str(d).split(":", 1)[0]] += 1
        _, blast = np.unique(fault_id[dom_mask], return_counts=True)
        out["domain_events"] = int(len(blast))
        out["domain_fault_fraction"] = round(
            float(dom_mask.sum()) / len(t), 4)
        out["blast_size_mean"] = round(float(blast.mean()), 2)
        out["blast_size_max"] = int(blast.max())
        out["events_by_kind"] = dict(sorted(kinds.items()))
    lag = detected_t - t
    lag = lag[(detected_t >= 0) & (lag > 0)]
    if len(lag):
        out["detection_lag_s"] = {
            "n": int(len(lag)),
            "mean": round(float(lag.mean()), 1),
            "p50": round(float(np.percentile(lag, 50)), 1),
            "p90": round(float(np.percentile(lag, 90)), 1),
        }
    return out


def job_size_mix(records) -> dict[int, dict[str, float]]:
    """Figure 6 / Observation 7: share of job attempts and of GPU-time per
    job size.

    Trace inputs: jobs table (``n_gpus``, runtime).  On RSC-1 the smallest
    half of jobs consumes a few percent of GPU-time while 1k+-GPU jobs
    dominate it — the "medians lie" observation."""
    records = _job_records(records)
    n = len(records)
    gpu_time = sum(r.run_time * r.n_gpus for r in records)
    jobs = defaultdict(float)
    time_share = defaultdict(float)
    for r in records:
        jobs[r.n_gpus] += 1
        time_share[r.n_gpus] += r.run_time * r.n_gpus
    return {size: {"job_fraction": jobs[size] / max(n, 1),
                   "gpu_time_share": time_share[size] / max(gpu_time, 1e-9)}
            for size in sorted(jobs)}


def preemption_cascades(records) -> dict:
    """Observation 9 / Figure 8: second-order preemption losses.

    Trace inputs: jobs table (``state``, ``preempted_by`` instigator
    links).  Splits lost GPU-hours into first-order (failures) and
    second-order (healthy victims preempted by recovering failed jobs) —
    the paper's preemption-cascade amplification."""
    records = _job_records(records)
    loss = goodput_loss(records)
    total = loss.failure_loss_gpu_s + loss.preemption_loss_gpu_s
    return {
        "failure_loss_gpu_h": loss.failure_loss_gpu_s / 3600.0,
        "preemption_loss_gpu_h": loss.preemption_loss_gpu_s / 3600.0,
        "second_order_fraction":
            loss.preemption_loss_gpu_s / max(total, 1e-9),
    }


def goodput_loss_by_size(records, assumed_cp_interval: float = 3600.0):
    """Figure 8: lost GPU-hours by job-size bucket, split first/second
    order.

    Trace inputs: jobs table (``n_gpus``, ``state``, ``hw_attributed``,
    ``preempted_by``).  Assumes hourly checkpoints, so each interruption
    loses at most 30 min x GPUs — the paper's Fig. 8 accounting."""
    records = _job_records(records)
    buckets = [(1, 8), (9, 256), (257, 512), (513, 1024), (1025, 2048),
               (2049, 4096)]
    out = {}
    for lo, hi in buckets:
        f_loss = p_loss = 0.0
        for r in records:
            if not (lo <= r.n_gpus <= hi):
                continue
            lost = min(r.run_time, assumed_cp_interval / 2.0) * r.n_gpus
            if r.state == JobState.NODE_FAIL or (
                    r.state == JobState.FAILED and r.hw_attributed):
                f_loss += lost
            elif r.state == JobState.PREEMPTED and r.preempted_by is not None:
                p_loss += lost
        out[f"{lo}-{hi}"] = {"failure_gpu_h": f_loss / 3600.0,
                             "preemption_gpu_h": p_loss / 3600.0}
    return out


def large_job_failure_rate(records, min_gpus: int = 512) -> float:
    """§IV-A lemon-detection headline: fraction of large-job attempts
    ending in NODE_FAIL / hw-attributed FAILED (the 14% -> 4% metric).

    Trace inputs: jobs table (``n_gpus``, ``state``, ``hw_attributed``)."""
    records = _job_records(records)
    big = [r for r in records if r.n_gpus >= min_gpus]
    if not big:
        return 0.0
    bad = [r for r in big
           if r.state == JobState.NODE_FAIL
           or (r.state == JobState.FAILED and r.hw_attributed)]
    return len(bad) / len(big)


def group_runs(records) -> dict[int, list[JobRecord]]:
    """Group job attempts into *job runs* (§II-D: requeued attempts share
    a ``run_id``) — the unit the ETTR/MTTF analyses score.

    Trace inputs: jobs table (``run_id``)."""
    records = _job_records(records)
    runs = defaultdict(list)
    for r in records:
        runs[r.run_id].append(r)
    return runs


def run_ettrs(records, *, min_gpus: int = 256, min_hours: float = 48.0,
              **ettr_kw):
    """Figure 9: measured ETTR per qualifying job run.

    Trace inputs: jobs table via ``group_runs`` (run grouping, queue and
    runtime per attempt, terminal states as §II-D interruptions).
    Returns ``[(n_gpus, RunETTR), ...]`` for runs with at least
    ``min_gpus`` GPUs and ``min_hours`` total runtime — compared against
    the analytical ``core.ettr_model`` expectation in Fig. 9 / Obs 10."""
    runs = group_runs(records)
    out = []
    for run_id, jobs in runs.items():
        if jobs[0].n_gpus < min_gpus:
            continue
        total_h = sum(j.run_time for j in jobs) / 3600.0
        if total_h < min_hours:
            continue
        out.append((jobs[0].n_gpus, job_run_ettr(jobs, **ettr_kw)))
    return out
