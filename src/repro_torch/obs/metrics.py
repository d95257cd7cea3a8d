"""Online metrics registry for live ``ClusterSim`` observability.

``ClusterSim(..., obs=MetricsRegistry())`` maintains operational health
metrics *while the replay runs* — the numbers the paper argues
reliability is won with (§III/§V): queue depth, GPU utilization,
rolling MTTF, a windowed ETTR proxy, per-domain fault rates,
detection-lag percentiles, and scheduling-pass timing — and emits a
snapshot of all of them every ``snapshot_interval_s`` of *simulated*
time (stamped at the first engine event after each boundary; the
registry never pushes events, so it cannot wake the engine up just to
snapshot).

Contract (mirrors ``TraceRecorder`` / the mitigation-policy hooks in
``cluster/scheduler.py``): the registry is a **pure observer** — it
never consumes engine RNG and never pushes events, so an instrumented
run is bit-for-bit identical to a bare one (gated against the five
committed sha256 engine digests in tests/test_obs.py) and ``obs=None``
costs one ``is not None`` check per hook site.

Hot-path design (the <5% overhead budget at the 2000-node scale is
enforced by ``benchmarks.run --only obs_bench``): the engine calls the
job-end hook ~60k times per simulated week at paper scales, so each
hook touches as few structures as possible —

* per-``JobState`` count cells cached in one small dict (enum
  ``.value`` is a DynamicClassAttribute descriptor, far too slow to
  pay per attempt; ``jobs_total`` / ``state_counts`` are derived
  properties);
* job gpu-time accumulates into two floats and rolls into a coarse
  time bucket (``window/24``) only at bucket edges, so the windowed
  ETTR is O(24) at snapshot time with no per-attempt storage;
* sched-pass wall times land in a log-bucket histogram (power-of-sqrt2
  buckets, one ``bit_length`` + one list increment per pass), so
  snapshot percentiles are O(#buckets) estimates (upper bucket bound,
  resolution ~±19%) instead of a sort over the window.

Derived-metric definitions:

* ``mttf_window_h`` — in-service node-hours per fault over a trailing
  ``window_s`` (24 h default): ``n_nodes * window / n_faults`` (node
  downtime inside the window is ignored — at paper fault rates it is a
  <1% correction).
* ``ettr_window`` — the online ETTR proxy over the trailing window:
  the fraction of scheduled GPU-time (attempts *ending* in the window,
  bucketed at window/24 granularity) not lost to infra interruptions
  (NODE_FAIL, hw-attributed FAILED, PREEMPTED, REQUEUED).  True
  per-run ETTR still comes from trace scoring
  (``ensemble.runner.score_cell``); this is the number a live
  dashboard can show without a finalized trace.
* ``detect_lag_s`` — exact percentiles of ``fault.detected_t -
  fault.t`` over faults injected in the trailing window (faults are
  rare, so this one keeps raw values).
* ``sched_pass_ms`` — wall-clock stats of ``_schedule_pass`` over the
  *last snapshot interval*.  The engine brackets only every
  ``scheduler.OBS_PASS_SAMPLE``-th pass with ``perf_counter`` (and only
  when a registry is attached), so n/mean/percentiles describe that
  sampled subset (``sample_stride`` is carried in the dict) and
  ``sched_wall_total_s`` is the sampled sum scaled back up.

External components (``runtime.monitor`` stragglers / collective
tracers, policies, serving loops) join snapshots through
:meth:`MetricsRegistry.add_source`.
"""
from __future__ import annotations

import time
from collections import Counter as _TallyCounter
from collections import deque
from typing import Callable, Optional

__all__ = ["MetricsRegistry", "WindowedHistogram",
           "INFRA_LOSS_STATES"]

# attempt-ending states whose runtime counts as *lost* for the windowed
# ETTR proxy (FAILED only when hw-attributed — user failures are not
# infra loss, matching analysis.infra_failure_mask)
INFRA_LOSS_STATES = frozenset({"NODE_FAIL", "PREEMPTED", "REQUEUED"})

# -- log-bucket histogram for sched-pass wall times ---------------------
# values are integer microseconds; bucket index = 2*bit_length + half
# step, giving power-of-sqrt2 buckets: one int op + one compare per
# insert, percentile estimates carry ~±19% resolution
_HIST_SLOTS = 128
_MID = tuple(3 << (b - 2) if b >= 2 else 4 for b in range(60))


def _bucket_upper_ms(idx: int) -> float:
    """Upper bound (ms) of log-bucket ``idx`` (values stored in us)."""
    b, half = divmod(idx, 2)
    if b == 0:
        return 0.0
    upper_us = (1 << (b - 1)) * (2.0 if half else 1.5)
    return round(upper_us / 1e3, 6)


def _hist_stats(hist: list, n: int, total: float) -> Optional[dict]:
    """{n, mean, p50, p90, p99, max} for one snapshot interval: exact
    n/mean (from the accumulated sum), log-bucket upper-bound estimates
    for the percentiles, or None when the interval saw no passes."""
    if not n:
        return None
    out = {"n": n, "mean": round(total / n * 1e3, 6)}
    targets = (("p50", 0.50), ("p90", 0.90), ("p99", 0.99))
    cum = 0
    ti = 0
    top = 0
    for i, c in enumerate(hist):
        if not c:
            continue
        cum += c
        top = i
        while ti < len(targets) and cum >= targets[ti][1] * n:
            out[targets[ti][0]] = _bucket_upper_ms(i)
            ti += 1
    out["max"] = _bucket_upper_ms(top)
    return out


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (no numpy on
    the snapshot path: snapshots must stay cheap and allocation-light)."""
    n = len(sorted_vals)
    if not n:
        return float("nan")
    idx = int(q / 100.0 * (n - 1) + 0.5)
    return sorted_vals[min(idx, n - 1)]


def _summary(values, *, scale: float = 1.0,
             pcts: tuple = (50.0, 90.0, 99.0)) -> Optional[dict]:
    """{n, mean, p50, p90, p99, max} over raw values (scaled at the
    edges only, so the sort runs on the stored floats), or None when
    empty."""
    svals = sorted(values)
    n = len(svals)
    if not n:
        return None
    out = {"n": n,
           "mean": round(sum(svals) / n * scale, 6),
           "max": round(svals[-1] * scale, 6)}
    for q in pcts:
        out[f"p{q:g}"] = round(_percentile(svals, q) * scale, 6)
    return out


class WindowedHistogram:
    """(t, value) pairs over a trailing simulated-time window.

    Appends are O(1); ``trim`` pops expired entries lazily; summary
    percentiles sort a snapshot-time copy.  Only suitable for *rare*
    event streams (faults/day at paper scales) — high-rate streams use
    the log-bucket histogram above instead."""

    __slots__ = ("window_s", "_items")

    def __init__(self, window_s: float):
        self.window_s = window_s
        self._items: deque = deque()

    def add(self, t: float, value: float) -> None:
        self._items.append((t, value))

    def trim(self, now: float) -> None:
        cutoff = now - self.window_s
        items = self._items
        while items and items[0][0] < cutoff:
            items.popleft()

    def __len__(self) -> int:
        return len(self._items)

    def values(self) -> list:
        return [v for _, v in self._items]

    def summary(self, *, scale: float = 1.0,
                pcts: tuple = (50.0, 90.0, 99.0)) -> Optional[dict]:
        """{n, mean, p50, p90, p99, max} (scaled), or None when empty."""
        return _summary((v for _, v in self._items),
                        scale=scale, pcts=pcts)


class MetricsRegistry:
    """Online counters / gauges / windowed statistics for one run.

    Hook methods (called by ``ClusterSim`` when attached via ``obs=``)
    are deliberately lean — a handful of scalar ops each; everything
    O(cluster) (node-state mix, busy GPUs) is polled only at snapshot
    boundaries."""

    def __init__(self, *, snapshot_interval_s: float = 6 * 3600.0,
                 window_s: float = 24 * 3600.0):
        if snapshot_interval_s <= 0:
            raise ValueError("snapshot_interval_s must be > 0")
        self.snapshot_interval_s = snapshot_interval_s
        self.window_s = window_s
        self.snapshots: list[dict] = []
        # per-JobState cells: state -> ([count], is_loss, is_failed,
        # name); jobs_total / state_counts are derived properties so the
        # hot hook pays one dict lookup + one list increment
        self._state_info: dict = {}
        # cumulative fault counters
        self.faults_total = 0
        self.fault_domain_counts = _TallyCounter()   # domain kind -> n
        self.fault_symptom_counts = _TallyCounter()
        self.drains_total = 0
        self.repairs_total = 0
        # sched-pass accumulators: [n_passes, started, preempted,
        # wall_sum_s, n_timed]; wall stats cover only the engine-sampled
        # passes (scheduler.OBS_PASS_SAMPLE, read at bind); _p_prev is
        # the copy taken at the last snapshot (interval stats are deltas
        # against it)
        self._p_acc: list = [0, 0, 0, 0.0, 0]
        self._p_prev: list = [0, 0, 0, 0.0, 0]
        self._pass_stride = 4
        self._pass_hist: list = [0] * _HIST_SLOTS
        # windowed ETTR state: gpu-time accumulates into _w_acc =
        # [gpu_s, lost_gpu_s] for the current coarse bucket (window/24)
        # and rolls into _jb_deque (bucket_end, gpu_s, lost) at edges
        self._bucket_s = window_s / 24.0
        self._w_acc: list = [0.0, 0.0]
        self._jb_deque: deque = deque()
        self._jb_end = self._bucket_s
        # rare-event windows keep raw values (exact percentiles)
        self._win_fault: deque = deque()      # (t, domain_kind)
        self._det_lag = WindowedHistogram(window_s)
        self._win_fault_append = self._win_fault.append
        self._det_lag_append = self._det_lag._items.append
        # gauges (last-seen values; refreshed at snapshot time too)
        self.queue_depth = 0
        self._next_snap = snapshot_interval_s
        # the job hook folds bucket rollover and snapshot triggering
        # into ONE comparison against the nearer of the two boundaries
        self._next_edge = min(self._jb_end, self._next_snap)
        self._sources: dict[str, Callable[[], dict]] = {}
        self._emitters: list[Callable[[dict], None]] = []
        self._sim = None
        self._bound = False
        self._wall_t0: Optional[float] = None
        self._node_down_code = 2      # scheduler.N_DOWN (refreshed at bind)
        self._node_draining_code = 1  # scheduler.N_DRAINING

    # -- derived cumulative counters -------------------------------------
    @property
    def jobs_total(self) -> int:
        return sum(info[0][0] for info in self._state_info.values())

    @property
    def state_counts(self) -> dict:
        return {info[3]: info[0][0]
                for info in self._state_info.values()}

    @property
    def sched_passes_total(self) -> int:
        return self._p_acc[0]

    @property
    def jobs_started_total(self) -> int:
        return self._p_acc[1]

    @property
    def preemptions_total(self) -> int:
        return self._p_acc[2]

    @property
    def sched_wall_total_s(self) -> float:
        """Estimated total ``_schedule_pass`` wall time: the sampled sum
        scaled by the engine's timing stride."""
        return self._p_acc[3] * self._pass_stride

    # -- wiring ----------------------------------------------------------
    def bind(self, sim) -> None:
        """Called by ``ClusterSim._run`` before the event loop starts.
        Never consumes RNG or seq — part of the bit-identity contract."""
        if self._bound:
            raise ValueError(
                "MetricsRegistry cannot be reused across runs (its "
                "windows and counters would silently merge) — create a "
                "fresh registry per ClusterSim")
        self._bound = True
        self._sim = sim
        from repro_torch.cluster.scheduler import (N_DOWN, N_DRAINING,
                                                   OBS_PASS_SAMPLE)
        self._node_down_code = N_DOWN
        self._node_draining_code = N_DRAINING
        self._pass_stride = OBS_PASS_SAMPLE
        self._wall_t0 = time.perf_counter()

    def add_source(self, name: str, poll: Callable[[], dict]) -> None:
        """Register an external metric source (e.g. a
        ``runtime.monitor.StragglerMonitor.as_metric_source()``); its
        dict is polled into every snapshot under ``sources.<name>``."""
        self._sources[name] = poll

    def attach_emitter(self, emit: Callable[[dict], None]) -> None:
        """Stream every snapshot dict to ``emit`` as it is taken (e.g.
        an ``obs.emit.JsonlWriter``)."""
        self._emitters.append(emit)

    # -- engine hooks (hot: keep these lean) -----------------------------
    def on_job_end(self, t: float, state, n_gpus: int, start_t: float,
                   hw: bool) -> None:
        """One job-attempt row was recorded (terminal or interrupted)."""
        info = self._state_info.get(state)
        if info is None:
            name = state.value
            info = ([0], name in INFRA_LOSS_STATES, name == "FAILED",
                    name)
            self._state_info[state] = info
        cnt, is_loss, is_failed, _ = info
        cnt[0] += 1
        gpu_s = (t - start_t) * n_gpus
        w = self._w_acc
        w[0] += gpu_s
        if is_loss or (hw and is_failed):
            w[1] += gpu_s
        if t >= self._next_edge:
            self._edge(t)

    def on_fault(self, fault) -> None:
        """One fault row was logged (independent chain or domain blast)."""
        self.faults_total += 1
        domain = fault.domain
        kind = domain.split(":", 1)[0] if domain else "independent"
        self.fault_domain_counts[kind] += 1
        self.fault_symptom_counts[fault.symptom] += 1
        t = fault.t
        self._win_fault_append((t, kind))
        if fault.detected_t >= t:
            self._det_lag_append((t, fault.detected_t - t))
        if t >= self._next_snap:
            self._snapshot(t)

    def on_sched_pass(self, t: float, n_queued: int, n_started: int,
                      n_preempted: int, blocked: bool,
                      wall_s: float) -> None:
        a = self._p_acc
        a[0] += 1
        a[1] += n_started
        a[2] += n_preempted
        self.queue_depth = n_queued
        if wall_s >= 0.0:   # engine-sampled pass (every stride-th)
            a[3] += wall_s
            a[4] += 1
            v = int(wall_s * 1e6) + 1
            b = v.bit_length()
            self._pass_hist[2 * b + (v >= _MID[b])] += 1
        if t >= self._next_snap:
            self._snapshot(t)

    def on_node_down(self, t: float, node_id: int, reason: str) -> None:
        self.drains_total += 1

    def on_node_up(self, t: float, node_id: int) -> None:
        self.repairs_total += 1

    # -- snapshotting ----------------------------------------------------
    def _edge(self, t: float) -> None:
        """Rare path behind the job hook's single boundary compare:
        roll the current gpu-time bucket and/or take a snapshot."""
        w = self._w_acc
        if w[0] or w[1]:
            self._jb_deque.append((self._jb_end, w[0], w[1]))
            w[0] = w[1] = 0.0
        self._jb_end = (t // self._bucket_s + 1.0) * self._bucket_s
        if t >= self._next_snap:
            self._snapshot(t)   # recomputes _next_edge
        else:
            ns = self._next_snap
            self._next_edge = self._jb_end if self._jb_end < ns else ns

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        win = self._win_fault
        while win and win[0][0] < cutoff:
            win.popleft()
        self._det_lag.trim(now)
        # expire whole gpu-time buckets; the boundary bucket stays until
        # it is fully outside the window, so the ETTR window carries up
        # to one bucket (window/24) of slack at the old edge
        jb = self._jb_deque
        while jb and jb[0][0] <= cutoff:
            jb.popleft()

    def mttf_window_h(self, now: float) -> Optional[float]:
        """Rolling MTTF: in-service node-hours per fault over the window
        (None while the window holds no faults)."""
        n = len(self._win_fault)
        if not n or self._sim is None:
            return None
        span_h = min(self.window_s, max(now, 1.0)) / 3600.0
        return self._sim.spec.n_nodes * span_h / n

    def ettr_window(self) -> Optional[float]:
        """Online ETTR proxy: non-lost fraction of scheduled GPU-time
        over attempts ending in the window (None when idle).  Sums the
        coarse gpu-time buckets plus the open bucket, so it is O(24)
        regardless of how many attempts ended in the window."""
        total, lost = self._w_acc
        for _, gpu_s, lost_s in self._jb_deque:
            total += gpu_s
            lost += lost_s
        if total <= 0.0:
            return None
        return (total - lost) / total

    def _snapshot(self, t: float) -> dict:
        sim = self._sim
        self._trim(t)
        # O(cluster) gauges: polled here only, never per event
        node_state = sim._node_state
        n_nodes = len(node_state)
        n_down = node_state.count(self._node_down_code)
        n_draining = node_state.count(self._node_draining_code)
        busy_gpus = sum(r.run.n_gpus for r in sim.running.values())
        in_service_gpus = (n_nodes - n_down) * sim.spec.gpus_per_node
        span_days = min(self.window_s, max(t, 1.0)) / 86400.0
        dom_rates = _TallyCounter()
        for _, kind in self._win_fault:
            dom_rates[kind] += 1
        per_1000_node_days = 1000.0 / (n_nodes * span_days)
        wall = (time.perf_counter() - self._wall_t0
                if self._wall_t0 is not None else 0.0)
        mttf = self.mttf_window_h(t)
        ettr = self.ettr_window()
        # interval sched-pass stats: deltas vs the last snapshot (wall
        # stats cover the engine-sampled subset of passes)
        acc, prev = self._p_acc, self._p_prev
        n_int = acc[0] - prev[0]
        wall_int = acc[3] - prev[3]
        n_timed_int = acc[4] - prev[4]
        pass_ms = _hist_stats(self._pass_hist, n_timed_int, wall_int)
        if pass_ms is not None:
            pass_ms["sample_stride"] = self._pass_stride
        snap = {
            "kind": "snapshot",
            "t": round(t, 3),
            "t_days": round(t / 86400.0, 4),
            "wall_s": round(wall, 3),
            "sim_days_per_wall_s": (round(t / 86400.0 / wall, 3)
                                    if wall > 0 else None),
            "jobs_total": self.jobs_total,
            "job_states": dict(sorted(self.state_counts.items())),
            "queue_depth": len(sim.queue) + len(sim._deferred),
            "running_jobs": len(sim.running),
            "busy_gpus": busy_gpus,
            "gpu_util": (round(busy_gpus / in_service_gpus, 4)
                         if in_service_gpus else 0.0),
            "nodes": {"total": n_nodes,
                      "active": n_nodes - n_down - n_draining,
                      "draining": n_draining, "down": n_down},
            "faults_total": self.faults_total,
            "fault_domains": dict(sorted(self.fault_domain_counts.items())),
            "fault_rate_window_per_1000_node_days": {
                k: round(v * per_1000_node_days, 4)
                for k, v in sorted(dom_rates.items())},
            "drains_total": self.drains_total,
            "repairs_total": self.repairs_total,
            "mttf_window_h": round(mttf, 3) if mttf is not None else None,
            "ettr_window": round(ettr, 5) if ettr is not None else None,
            "detect_lag_s": self._det_lag.summary(),
            "sched_pass_ms": pass_ms,
            "sched_queue_depth": (
                {"n": n_int, "last": self.queue_depth}
                if n_int else None),
            "sched_passes_total": acc[0],
            "jobs_started_total": acc[1],
            "preemptions_total": acc[2],
        }
        if self._sources:
            snap["sources"] = {name: poll()
                               for name, poll in sorted(
                                   self._sources.items())}
        self.snapshots.append(snap)
        for emit in self._emitters:
            emit(snap)
        # reset the interval histogram and baseline
        self._pass_hist = [0] * _HIST_SLOTS
        self._p_prev = acc.copy()
        # one snapshot per boundary crossing, however far t jumped
        step = self.snapshot_interval_s
        self._next_snap = (t // step + 1.0) * step
        self._next_edge = min(self._jb_end, self._next_snap)
        return snap

    def finalize(self, sim=None) -> dict:
        """Take a closing snapshot at the current simulated time and
        return a compact run summary.  Idempotent-ish: safe to call once
        after ``sim.run()`` (the closing snapshot is always taken so the
        stream covers the full horizon)."""
        sim = sim or self._sim
        if sim is None:
            raise ValueError("finalize() before bind(): attach the "
                             "registry to a ClusterSim via obs=")
        last = self._snapshot(max(sim._now, sim.horizon_s))
        return {
            "n_snapshots": len(self.snapshots),
            "jobs_total": self.jobs_total,
            "faults_total": self.faults_total,
            "drains_total": self.drains_total,
            "sched_passes_total": self.sched_passes_total,
            "sched_wall_total_s": round(self.sched_wall_total_s, 4),
            "final": last,
        }
