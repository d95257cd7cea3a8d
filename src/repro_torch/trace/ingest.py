"""External-trace ingestion: map Philly-style CSV job tables onto the
repro-trace schema.

The paper's analyses (and this repo's reproduction of them) only need a
scheduler job log — the shape popularized by the Philly trace study
(Jeon et al., ATC'19: one row per job with submit/start/finish times,
GPU count, and terminal status).  ``ingest_philly_csv`` adapts any such
table into a ``schema.Trace`` whose jobs table feeds every metric in
``repro_torch.cluster.analysis`` and the ``repro_torch.trace.report`` CLI; the
fault/node tables stay empty, and fault-derived figures degrade
gracefully.

Recognized columns (case-insensitive; first alias present wins):

  job id       jobid | job_id | id
  status       status | state
  gpus         gpu_num | num_gpus | gpus | n_gpus
  submit time  submitted_time | submit_time | submit_t
  start time   start_time | started_time | start_t
  end time     finished_time | finish_time | end_time | end_t
  priority     priority (optional, default 0)

Timestamps may be epoch seconds or ``YYYY-MM-DD HH:MM:SS`` /
ISO-8601 datetimes; the trace clock is shifted so the earliest submit
is t=0 (the wall origin is kept in ``meta["t0"]``).  Rows whose job
never started (missing/empty start or end time) are counted in
``meta["n_skipped"]`` and dropped — they carry no runtime and the
queue-only information is not attributable to a terminal state.
Repeated rows with the same job id are treated as attempts of one
logical run (shared ``run_id``), matching the simulator's requeue
semantics.
"""
from __future__ import annotations

import csv
import math
from datetime import datetime, timezone
from typing import Optional

from repro_torch.trace.schema import (NO_JOB, SCHEMA, TABLES, Trace, empty_table,
                                      table_from_columns)

# external status label -> core.metrics.JobState value
STATUS_MAP = {
    "pass": "COMPLETED", "passed": "COMPLETED", "completed": "COMPLETED",
    "success": "COMPLETED", "succeeded": "COMPLETED",
    "killed": "CANCELLED", "cancelled": "CANCELLED", "canceled": "CANCELLED",
    "failed": "FAILED", "error": "FAILED",
    "node_fail": "NODE_FAIL", "oom": "OUT_OF_MEMORY",
    "out_of_memory": "OUT_OF_MEMORY", "preempted": "PREEMPTED",
    "requeued": "REQUEUED", "timeout": "TIMEOUT",
}

_ALIASES = {
    "job_id": ("jobid", "job_id", "id"),
    "status": ("status", "state"),
    "n_gpus": ("gpu_num", "num_gpus", "gpus", "n_gpus"),
    "submit_t": ("submitted_time", "submit_time", "submit_t"),
    "start_t": ("start_time", "started_time", "start_t"),
    "end_t": ("finished_time", "finish_time", "end_time", "end_t"),
    "priority": ("priority",),
}

_DT_FORMATS = ("%Y-%m-%d %H:%M:%S", "%Y-%m-%dT%H:%M:%S",
               "%Y-%m-%d %H:%M", "%m/%d/%Y %H:%M:%S")


def _parse_time(cell: Optional[str]) -> Optional[float]:
    """Epoch-seconds float from a numeric or datetime cell; None if the
    cell is empty/unparsable (e.g. Philly's 'None' for never-started)."""
    if cell is None:
        return None
    cell = cell.strip()
    if not cell or cell.lower() in ("none", "null", "na", "n/a"):
        return None
    try:
        v = float(cell)
        return v if math.isfinite(v) else None   # 'nan'/'inf' cells
    except ValueError:
        pass
    for fmt in _DT_FORMATS:
        try:
            dt = datetime.strptime(cell, fmt)
            return dt.replace(tzinfo=timezone.utc).timestamp()
        except ValueError:
            continue
    return None


def _map_status(cell: Optional[str], unknown: dict) -> str:
    s = (cell or "").strip()
    mapped = STATUS_MAP.get(s.lower())
    if mapped is not None:
        return mapped
    if s.upper() in ("COMPLETED", "CANCELLED", "FAILED", "NODE_FAIL",
                     "OUT_OF_MEMORY", "PREEMPTED", "REQUEUED", "TIMEOUT"):
        return s.upper()
    # conservative default for unknown terminal labels — counted in
    # meta["unknown_statuses"] so the misclassification is visible
    unknown[s] = unknown.get(s, 0) + 1
    return "FAILED"


def _resolve(fieldnames, key: str) -> Optional[str]:
    lowered = {f.strip().lower(): f for f in fieldnames}
    for alias in _ALIASES[key]:
        if alias in lowered:
            return lowered[alias]
    return None


def ingest_philly_csv(path: str, *, cluster: str = "philly",
                      n_nodes: Optional[int] = None,
                      gpus_per_node: int = 8) -> Trace:
    """Read a Philly-style CSV job table into a ``Trace``.

    ``n_nodes`` is unknown for most external tables; pass it if you know
    the cluster size, otherwise per-node-normalized figures are skipped
    by the report."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if not reader.fieldnames:
            raise ValueError(f"{path!r}: empty CSV (no header)")
        col = {k: _resolve(reader.fieldnames, k) for k in _ALIASES}
        for req in ("job_id", "status", "n_gpus", "submit_t", "start_t",
                    "end_t"):
            if col[req] is None:
                raise ValueError(
                    f"{path!r}: no column for {req!r} "
                    f"(accepted aliases: {', '.join(_ALIASES[req])})")
        rows = list(reader)

    run_ids: dict[str, int] = {}
    cols: dict[str, list] = {c: [] for c, _ in TABLES["jobs"]}
    n_skipped = 0
    unknown_statuses: dict[str, int] = {}
    for i, row in enumerate(rows):
        submit = _parse_time(row.get(col["submit_t"]))
        start = _parse_time(row.get(col["start_t"]))
        end = _parse_time(row.get(col["end_t"]))
        if submit is None and start is not None:
            submit = start   # tables without queue information
        if start is not None and submit is not None:
            start = max(start, submit)   # clock skew: start before submit
        if submit is None or start is None or end is None or end < start:
            n_skipped += 1
            continue
        try:
            gpus = max(int(float(row.get(col["n_gpus"]) or 0)), 1)
        except ValueError:
            n_skipped += 1
            continue
        key = (row.get(col["job_id"]) or f"row{i}").strip()
        run_id = run_ids.setdefault(key, len(run_ids))
        prio = 0
        if col["priority"] is not None:
            try:
                prio = int(float(row.get(col["priority"]) or 0))
            except ValueError:
                prio = 0
        cols["job_id"].append(i)
        cols["run_id"].append(run_id)
        cols["n_gpus"].append(gpus)
        cols["submit_t"].append(submit)
        cols["start_t"].append(start)
        cols["end_t"].append(end)
        cols["state"].append(_map_status(row.get(col["status"]),
                                         unknown_statuses))
        cols["priority"].append(prio)
        cols["hw_attributed"].append(False)
        cols["symptoms"].append("")
        cols["preempted_by"].append(NO_JOB)

    if not cols["job_id"]:
        raise ValueError(f"{path!r}: no ingestible rows "
                         f"({n_skipped} skipped)")
    t0 = min(cols["submit_t"])
    for key in ("submit_t", "start_t", "end_t"):
        cols[key] = [v - t0 for v in cols[key]]
    horizon_s = max(cols["end_t"])

    tables = {"jobs": table_from_columns("jobs", cols)}
    for name in ("faults", "node_events", "sched_passes", "checkpoints"):
        tables[name] = empty_table(name)
    meta = {"schema": SCHEMA, "source": "ingest:philly", "cluster": cluster,
            "n_nodes": n_nodes, "gpus_per_node": gpus_per_node,
            "horizon_s": horizon_s, "t0": t0, "n_skipped": n_skipped,
            "ingest_path": path}
    if unknown_statuses:
        meta["unknown_statuses"] = unknown_statuses
    return Trace(meta, tables).validate()
