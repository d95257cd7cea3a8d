"""TraceRecorder: the scheduler's zero-overhead-when-off trace hook.

``ClusterSim(..., recorder=TraceRecorder())`` streams the events the
engine does not already persist (scheduling passes, node state
transitions, checkpoint events) into chunked columnar stores
(``repro_torch.trace.store.ChunkedStore``); ``finalize(sim)`` assembles a
``schema.Trace`` whose job/fault tables come straight from the engine's
own columnar logs — a near-free per-column slice/concat + vocabulary
decode, not the v2 row-tuple transpose of millions of records.

Streaming spill mode: ``TraceRecorder(trace_spill_dir=...)`` redirects
every completed chunk — the engine's job/fault logs included — to npz
part files under that directory, so a full 330-day RSC-1 replay records
in near-constant RSS.  ``finalize`` then writes the manifest and
returns a lazily-loaded ``Trace`` over the parts (``trace_io.load``
reopens the directory later).

Contract (mirrors the mitigation-policy hook contract in
``cluster/scheduler.py``): the recorder is a pure observer — it never
consumes engine RNG and never pushes events, so a recorded run is
bit-for-bit identical to an unrecorded one, and with ``recorder=None``
the only cost is a per-hook ``is not None`` check (regression-tested in
tests/test_trace.py).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.trace import io as trace_io
from repro_torch.trace.schema import NODE_EVENTS, SCHEMA, Trace
from repro_torch.trace.store import ChunkedStore, Interner


class TraceRecorder:
    """Accumulates trace rows during a simulation run."""

    def __init__(self, trace_spill_dir: Optional[str] = None):
        self.meta: dict = {"schema": SCHEMA, "source": "sim"}
        self.trace_spill_dir = trace_spill_dir
        self._event_int = Interner()
        self._event_int.seed(NODE_EVENTS)
        self._event_code = {e: i for i, e in enumerate(NODE_EVENTS)}
        self._reason_int = Interner()
        self._reason_int.code("")                  # code 0 == no reason
        self._kind_int = Interner()
        self._kind_int.code("write")               # the common default
        self._node_events = ChunkedStore("node_events", interners={
            "event": self._event_int, "reason": self._reason_int})
        self._sched = ChunkedStore("sched_passes")
        self._checkpoints = ChunkedStore("checkpoints", interners={
            "kind": self._kind_int})
        self._bound = False
        self._sim = None

    # -- hooks called by ClusterSim -------------------------------------
    def bind(self, sim) -> None:
        if self._bound:
            raise ValueError(
                "TraceRecorder cannot be reused across runs (its event "
                "streams would silently merge) — create a fresh recorder "
                "per ClusterSim")
        self._bound = True
        self._sim = sim
        spec = sim.spec
        scenario = getattr(sim, "scenario", None)
        self.meta.update(
            cluster=spec.name, n_nodes=spec.n_nodes,
            gpus_per_node=spec.gpus_per_node, horizon_s=sim.horizon_s,
            seed=sim.seed, r_f=spec.r_f,
            scenario=("independent-v1" if scenario is None
                      else scenario.name))
        if self.trace_spill_dir is not None:
            # constant-RSS mode: chunks stream to part files as they
            # fill, for the engine's job/fault logs too (bind runs
            # before any rows exist)
            for store in (self._node_events, self._sched,
                          self._checkpoints):
                store.spill_to(self.trace_spill_dir)
            sim._enable_trace_spill(self.trace_spill_dir)

    def on_node_event(self, t: float, node_id: int, event: str,
                      reason: str = "") -> None:
        self._node_events.append(
            (t, node_id, self._event_code[event],
             self._reason_int.code(reason)))

    def on_sched_pass(self, t: float, n_queued: int, n_started: int,
                      n_preempted: int, blocked: bool) -> None:
        self._sched.append((t, n_queued, n_started, n_preempted, blocked))

    def on_checkpoint(self, t: float, job_id: int, dur_s: float,
                      kind: str = "write") -> None:
        """For checkpoint-aware policies / runtime traces; the bare
        simulator emits none (analytic checkpoint accounting)."""
        self._checkpoints.append((t, job_id, dur_s,
                                  self._kind_int.code(kind)))

    # -- snapshot/restore (replay forking) -------------------------------
    def snapshot_state(self) -> dict:
        """State capture for ``ClusterSim.snapshot()``: meta plus the
        recorder-owned stores/vocabularies (the job/fault tables live in
        the engine's own logs and are captured there).  Chunks are
        shared copy-on-write — see ``ChunkedStore.snapshot_state``."""
        if self.trace_spill_dir is not None:
            raise ValueError(
                "cannot snapshot a spilling TraceRecorder — replay "
                "forking requires in-memory recording")
        return {
            "meta": dict(self.meta),
            "event_int": self._event_int.snapshot_state(),
            "reason_int": self._reason_int.snapshot_state(),
            "kind_int": self._kind_int.snapshot_state(),
            "node_events": self._node_events.snapshot_state(),
            "sched": self._sched.snapshot_state(),
            "checkpoints": self._checkpoints.snapshot_state(),
        }

    @classmethod
    def from_snapshot_state(cls, state: dict, sim=None) -> "TraceRecorder":
        """Rebuild a recorder mid-stream from a ``snapshot_state``
        capture.  The result is already *bound* (``bind`` ran in the
        original run and must not run again — it would re-enter spill
        setup and re-stamp meta); ``ClusterSim.restore`` passes ``sim``
        to re-attach it to the forked engine."""
        rec = cls()
        rec.meta = dict(state["meta"])
        rec._event_int = Interner.from_state(state["event_int"])
        rec._reason_int = Interner.from_state(state["reason_int"])
        rec._kind_int = Interner.from_state(state["kind_int"])
        rec._node_events = ChunkedStore("node_events", interners={
            "event": rec._event_int, "reason": rec._reason_int})
        rec._node_events.restore_state(state["node_events"])
        rec._sched = ChunkedStore("sched_passes")
        rec._sched.restore_state(state["sched"])
        rec._checkpoints = ChunkedStore("checkpoints", interners={
            "kind": rec._kind_int})
        rec._checkpoints.restore_state(state["checkpoints"])
        rec._bound = True
        rec._sim = sim
        return rec

    # -- finalize --------------------------------------------------------
    def _stores(self, sim) -> dict[str, ChunkedStore]:
        return {"jobs": sim._jobs_log, "faults": sim._faults_log,
                "node_events": self._node_events,
                "sched_passes": self._sched,
                "checkpoints": self._checkpoints}

    def finalize(self, sim) -> Trace:
        """Assemble the run's ``Trace`` (call after ``sim.run()``).

        In-memory mode this is a near-free per-column concat of the
        columnar chunks (plus one vectorized vocabulary decode per str
        column); nothing is transposed and no row objects exist.  In
        spill mode the staging tails flush to final part files, the
        manifest is written, and the returned trace loads its columns
        lazily from the parts.  Idempotent either way."""
        stores = self._stores(sim)
        if self.trace_spill_dir is not None:
            info = {}
            for name, store in stores.items():
                store._flush()
                info[name] = (store.parts, store.rows)
            trace_io.write_spill_manifest(self.trace_spill_dir,
                                          dict(self.meta), info)
            return trace_io.load_spill(self.trace_spill_dir)
        tables = {name: store.finalize_columns()
                  for name, store in stores.items()}
        return Trace(dict(self.meta), tables).validate()


def simulate_trace(spec, *, horizon_days: float = 8.0, seed: int = 0,
                   trace_spill_dir: Optional[str] = None, setup=None,
                   **sim_kw):
    """Convenience: run a ``ClusterSim`` with a recorder attached and
    return ``(sim, trace)`` — the "record trace -> analyze trace" path.
    ``trace_spill_dir`` enables constant-RSS streaming recording;
    ``setup(sim)`` (if given) runs between construction and ``run()``
    (e.g. to attach an ``obs.EngineProfiler``); other keywords — incl.
    ``obs=MetricsRegistry()`` — pass straight through to ``ClusterSim``."""
    from repro_torch.cluster.scheduler import ClusterSim

    rec = TraceRecorder(trace_spill_dir=trace_spill_dir)
    sim = ClusterSim(spec, horizon_days=horizon_days, seed=seed,
                     recorder=rec, **sim_kw)
    if setup is not None:
        setup(sim)
    sim.run()
    return sim, rec.finalize(sim)
