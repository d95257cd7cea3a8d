"""Columnar trace schema — the simulator's first-class output.

A *trace* is the workload-agnostic record of everything a reliability
analysis needs: job attempts (the paper's scheduler-log unit, §II-B),
node faults with Table I taxonomy labels, node state transitions,
checkpoint events, and scheduling passes.  Every §III metric in
``repro_torch.cluster.analysis`` computes from a ``Trace``, so the same
figure pipeline runs over a simulated replay, a saved trace, or an
ingested external job table (``repro_torch.trace.ingest``) — the paper's
closing call for *flexible, workload-agnostic* reliability tooling.

Tables are column-oriented (one numpy array per column, ``TABLES``
below is the authoritative layout) so a paper-scale trace — ~2.4M job
attempts for an 11-month RSC-1 replay — stays compact on disk and
round-trips bit-exactly through npz/jsonl (``repro_torch.trace.io``).

See ``docs/trace_schema.md`` for the column-by-column paper mapping.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.cluster.failures import Fault
from repro_torch.core.metrics import JobRecord, JobState

SCHEMA = "repro-trace/v2"
SCHEMA_V1 = "repro-trace/v1"
KNOWN_SCHEMAS = (SCHEMA, SCHEMA_V1)

# jobs.preempted_by sentinel: not a second-order preemption (no instigator)
NO_JOB = -1

# table -> ((column, kind), ...); kind in {"f8", "i8", "bool", "str"}.
# Multi-valued string columns (jobs.symptoms, faults.co_symptoms) are
# "|"-joined; the empty string means the empty tuple.
TABLES: dict[str, tuple[tuple[str, str], ...]] = {
    # one row per scheduler job attempt (paper §II-B job records; requeued
    # attempts share a run_id — the §II-D "job run" the ETTR analyses score)
    "jobs": (
        ("job_id", "i8"), ("run_id", "i8"), ("n_gpus", "i8"),
        ("submit_t", "f8"), ("start_t", "f8"), ("end_t", "f8"),
        ("state", "str"), ("priority", "i8"), ("hw_attributed", "bool"),
        ("symptoms", "str"), ("preempted_by", "i8"),
    ),
    # one row per hardware fault event (Table I taxonomy labels); the
    # trailing three columns are fault-model v2 additions (correlated
    # domain label, blast-grouping fault id, detection timestamp) —
    # optional on v1 traces, see OPTIONAL_COLUMNS
    "faults": (
        ("t", "f8"), ("node_id", "i8"), ("symptom", "str"),
        ("co_symptoms", "str"), ("transient", "bool"),
        ("detectable", "bool"), ("repair_s", "f8"),
        ("domain", "str"), ("fault_id", "i8"), ("detected_t", "f8"),
    ),
    # node state transitions: drain / repair / hold / release / evict
    "node_events": (
        ("t", "f8"), ("node_id", "i8"), ("event", "str"), ("reason", "str"),
    ),
    # one row per 30 s-tick scheduling pass that actually ran
    "sched_passes": (
        ("t", "f8"), ("n_queued", "i8"), ("n_started", "i8"),
        ("n_preempted", "i8"), ("blocked", "bool"),
    ),
    # checkpoint write events (empty for the bare simulator — reserved for
    # checkpoint-aware policies, runtime traces, and external ingests)
    "checkpoints": (
        ("t", "f8"), ("job_id", "i8"), ("dur_s", "f8"), ("kind", "str"),
    ),
}

NODE_EVENTS = ("drain", "repair", "hold", "release", "evict")

# Columns added by schema v2 and therefore absent from v1 traces, with
# the default cell value analyses assume when the column is missing.
# Loaders, validate() and the materializers treat these as optional so a
# v1 npz/jsonl/spill trace keeps loading (schema-version check, not
# KeyError).
OPTIONAL_COLUMNS: dict[tuple[str, str], object] = {
    ("faults", "domain"): "",
    ("faults", "fault_id"): -1,
    ("faults", "detected_t"): -1.0,
}

_NP_DTYPE = {"f8": np.float64, "i8": np.int64, "bool": np.bool_}


def default_column(table: str, col: str, n: int) -> np.ndarray:
    """Default-filled array for an optional column missing from a v1
    trace (``n`` rows)."""
    kind = dict(TABLES[table])[col]
    value = OPTIONAL_COLUMNS[(table, col)]
    if kind == "str":
        return (np.full(n, value, dtype=np.str_) if n
                else np.empty(0, dtype="<U1"))
    return np.full(n, value, dtype=_NP_DTYPE[kind])


def _column(kind: str, values) -> np.ndarray:
    if kind == "str":
        return (np.array(values, dtype=np.str_) if len(values)
                else np.empty(0, dtype="<U1"))
    # fromiter beats array(list) ~2x for scalar columns — finalize cost is
    # the bulk of the trace_bench recording-overhead budget
    return np.fromiter(values, dtype=_NP_DTYPE[kind], count=len(values))


def table_from_columns(name: str, columns: dict[str, list]) -> dict:
    """Build one schema table from per-column Python lists."""
    return {col: _column(kind, columns.get(col, []))
            for col, kind in TABLES[name]}


def empty_table(name: str) -> dict:
    return table_from_columns(name, {})


def join_multi(values) -> str:
    """Encode a tuple of labels as one string cell ("" = empty tuple)."""
    return "|".join(values)


def split_multi(cell: str) -> tuple[str, ...]:
    return tuple(cell.split("|")) if cell else ()


@dataclass(eq=False)
class Trace:
    """One cluster trace: ``meta`` dict + the columnar ``tables``.

    ``meta`` carries the cluster context the figure analyses need beyond
    the events themselves: ``cluster`` name, ``n_nodes``,
    ``gpus_per_node``, ``horizon_s``, ``seed``, ``r_f`` and
    ``source`` ("sim" or "ingest:<kind>").  Ingested external traces may
    leave unknown fields (e.g. ``n_nodes``) as None; analyses degrade
    gracefully (see ``repro_torch.trace.report``).
    """

    meta: dict
    tables: dict[str, dict[str, np.ndarray]]
    _job_cache: Optional[list] = field(default=None, repr=False, compare=False)
    _fault_cache: Optional[list] = field(default=None, repr=False,
                                         compare=False)

    def __eq__(self, other) -> bool:
        """Value equality over meta + every table column (the generated
        dataclass __eq__ would raise on numpy-array truthiness).
        Optional v2 columns missing on either side compare as their
        default fill, so a v1 trace equals its default-extended self."""
        if not isinstance(other, Trace):
            return NotImplemented
        if self.meta != other.meta:
            return False
        return all(
            np.array_equal(self.column(name, col), other.column(name, col))
            for name, cols in TABLES.items() for col, _ in cols)

    def has_column(self, table: str, col: str) -> bool:
        """True when the column is actually present (v1 traces lack the
        v2 fault columns — analyses gate their domain/stage sections on
        this instead of KeyError-ing)."""
        return col in self.tables[table]

    def column(self, table: str, col: str) -> np.ndarray:
        """The column array, default-filled when an optional v2 column
        is absent (v1 trace)."""
        tbl = self.tables[table]
        if col in tbl:
            return tbl[col]
        if (table, col) in OPTIONAL_COLUMNS:
            return default_column(table, col, self.n_rows(table))
        raise KeyError(f"table {table!r} has no column {col!r}")

    # -- meta accessors -------------------------------------------------
    @property
    def cluster(self) -> str:
        return self.meta.get("cluster", "?")

    @property
    def n_nodes(self) -> Optional[int]:
        return self.meta.get("n_nodes")

    @property
    def gpus_per_node(self) -> int:
        return self.meta.get("gpus_per_node") or 8

    @property
    def n_gpus(self) -> Optional[int]:
        n = self.n_nodes
        return None if n is None else n * self.gpus_per_node

    @property
    def horizon_s(self) -> Optional[float]:
        return self.meta.get("horizon_s")

    @property
    def horizon_days(self) -> Optional[float]:
        h = self.horizon_s
        return None if h is None else h / 86400.0

    def n_rows(self, table: str) -> int:
        cols = self.tables[table]
        rows = getattr(cols, "rows", None)   # spill views know their count
        if rows is not None:
            return rows
        first = TABLES[table][0][0]
        return len(cols[first])

    # -- materialization ------------------------------------------------
    def job_records(self) -> list[JobRecord]:
        """Materialize the jobs table as ``core.metrics.JobRecord`` objects
        (cached) — the common currency of every §III metric function."""
        if self._job_cache is None:
            t = self.tables["jobs"]
            cols = [t[c].tolist() for c, _ in TABLES["jobs"]]
            recs = []
            for (jid, rid, g, sub, st, en, state, prio, hw, sym,
                 pb) in zip(*cols):
                recs.append(JobRecord(
                    job_id=jid, run_id=rid, n_gpus=g, submit_t=sub,
                    start_t=st, end_t=en, state=JobState(state),
                    priority=prio, hw_attributed=hw,
                    symptoms=split_multi(sym),
                    preempted_by=None if pb == NO_JOB else pb))
            self._job_cache = recs
        return self._job_cache

    def fault_records(self) -> list[Fault]:
        """Materialize the faults table as ``cluster.failures.Fault``
        (cached, like ``job_records``)."""
        if self._fault_cache is None:
            cols = [self.column("faults", c).tolist()
                    for c, _ in TABLES["faults"]]
            self._fault_cache = [
                Fault(tt, nid, sym, split_multi(cos), tr, det, rep,
                      dom, fid, dt)
                for tt, nid, sym, cos, tr, det, rep, dom, fid, dt
                in zip(*cols)]
        return self._fault_cache

    def job_records_at(self, indices) -> list[JobRecord]:
        """Materialize only the jobs-table rows at ``indices`` (a numpy
        index array, in the caller's order) — the hot-path-v3 scoring
        route: `ensemble.runner.score_cell` computes its aggregates as
        column array ops and materializes ``JobRecord`` objects solely
        for the few ETTR-qualifying rows, never the full table."""
        t = self.tables["jobs"]
        cols = [t[c][indices].tolist() for c, _ in TABLES["jobs"]]
        return [
            JobRecord(jid, rid, g, sub, st, en, JobState(state), prio, hw,
                      split_multi(sym), None if pb == NO_JOB else pb)
            for (jid, rid, g, sub, st, en, state, prio, hw, sym,
                 pb) in zip(*cols)]

    # -- hygiene ---------------------------------------------------------
    def validate(self) -> "Trace":
        """Schema check: every table present with every required column,
        consistent row counts per table, and a known schema version
        (v1 traces may omit the OPTIONAL_COLUMNS).  (Row order is not
        constrained — ingested tables may be non-chronological.)"""
        for name, cols in TABLES.items():
            tbl = self.tables.get(name)
            if tbl is None:
                raise ValueError(f"trace missing table {name!r}")
            lazy = getattr(tbl, "rows", None) is not None
            lens = set()
            for col, _ in cols:
                if col not in tbl:
                    if (name, col) in OPTIONAL_COLUMNS:
                        continue
                    raise ValueError(f"table {name!r} missing column {col!r}")
                if not lazy:   # spill views are uniform by construction
                    lens.add(len(tbl[col]))
            if len(lens) > 1:
                raise ValueError(f"table {name!r} has ragged columns: {lens}")
        events = self.tables["node_events"]["event"]
        if len(events):
            bad = set(np.unique(events).tolist()) - set(NODE_EVENTS)
            if bad:
                raise ValueError(
                    f"unknown node_events.event values: {sorted(bad)} "
                    f"(vocabulary: {NODE_EVENTS})")
        if self.meta.get("schema") not in KNOWN_SCHEMAS:
            raise ValueError(f"unknown trace schema {self.meta.get('schema')!r}"
                             f" (expected one of {KNOWN_SCHEMAS})")
        return self

    def summary(self) -> dict:
        out = {"source": self.meta.get("source", "?"),
               "cluster": self.cluster}
        for k in ("n_nodes", "gpus_per_node", "seed"):
            if self.meta.get(k) is not None:
                out[k] = self.meta[k]
        if self.horizon_days is not None:
            out["horizon_days"] = round(self.horizon_days, 3)
        for name in TABLES:
            out[f"n_{name}"] = self.n_rows(name)
        return out
