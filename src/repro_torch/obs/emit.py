"""Snapshot / heartbeat emission: jsonl streams, Prometheus text, ETA.

Two channels with different clocks:

* **Snapshots** (simulated time): ``MetricsRegistry`` snapshots stream
  through :class:`JsonlWriter` (one JSON object per line, flushed per
  snapshot so ``tail -f`` works on a live run) and render to the
  Prometheus text-exposition format via :func:`to_prometheus` for
  scrape-style integration.
* **Heartbeats** (wall-clock): :class:`Heartbeat` is the progress
  channel for the worker-pool grids (``repro_torch.ensemble.run`` /
  ``repro_torch.mitigations.sweep`` ``--progress``).  It rides the existing
  result queue — ``run_cells`` already streams per-cell results back in
  completion order, so the heartbeat folds each landing cell into
  done/total, ETA, and pool efficiency without any new IPC.

``python -m repro_torch.obs.report FILE.jsonl`` renders either stream (they
share the jsonl container, discriminated by the ``kind`` field).
"""
from __future__ import annotations

import json
import time
from typing import Callable, Optional

__all__ = ["JsonlWriter", "read_jsonl", "to_prometheus", "Heartbeat"]


class JsonlWriter:
    """Append-one-JSON-object-per-line stream, flushed per record (the
    file is valid and tailable at every instant of a live run)."""

    def __init__(self, path: str):
        self.path = path
        self.n_written = 0
        self._f = open(path, "w")

    def __call__(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        self.n_written += 1

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path: str) -> list[dict]:
    """Read a snapshot/heartbeat jsonl stream back (blank lines are
    tolerated: a killed run may leave a trailing partial line, which is
    reported rather than silently dropped)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{i + 1}: truncated/corrupt jsonl record "
                    f"({e})") from e
    return out


# -- Prometheus text exposition ---------------------------------------------
def _prom_lines(name: str, kind: str, help_: str,
                samples: list[tuple[str, float]]) -> list[str]:
    lines = [f"# HELP {name} {help_}", f"# TYPE {name} {kind}"]
    for labels, value in samples:
        lines.append(f"{name}{labels} {value:g}")
    return lines


def to_prometheus(registry, *, prefix: str = "repro") -> str:
    """Render the registry's cumulative counters plus its latest
    snapshot's gauges/percentiles in the Prometheus text-exposition
    format (the scrape-endpoint lingua franca; `# TYPE`d families,
    label-encoded breakdowns)."""
    p = prefix
    out: list[str] = []
    out += _prom_lines(
        f"{p}_jobs_total", "counter", "job attempts recorded",
        [("", registry.jobs_total)])
    out += _prom_lines(
        f"{p}_job_state_total", "counter", "job attempts by final state",
        [(f'{{state="{s}"}}', n)
         for s, n in sorted(registry.state_counts.items())])
    out += _prom_lines(
        f"{p}_faults_total", "counter", "faults logged",
        [("", registry.faults_total)])
    out += _prom_lines(
        f"{p}_fault_domain_total", "counter", "faults by domain kind",
        [(f'{{domain="{d}"}}', n)
         for d, n in sorted(registry.fault_domain_counts.items())])
    out += _prom_lines(
        f"{p}_node_drains_total", "counter", "node drain events",
        [("", registry.drains_total)])
    out += _prom_lines(
        f"{p}_node_repairs_total", "counter", "node return-to-service events",
        [("", registry.repairs_total)])
    out += _prom_lines(
        f"{p}_sched_passes_total", "counter", "scheduling passes run",
        [("", registry.sched_passes_total)])
    if registry.snapshots:
        snap = registry.snapshots[-1]
        out += _prom_lines(
            f"{p}_sim_time_days", "gauge", "simulated time of last snapshot",
            [("", snap["t_days"])])
        for key, help_ in (("queue_depth", "jobs queued or deferred"),
                           ("running_jobs", "jobs currently running"),
                           ("busy_gpus", "GPUs allocated to running jobs"),
                           ("gpu_util", "busy / in-service GPUs")):
            out += _prom_lines(f"{p}_{key}", "gauge", help_,
                               [("", snap[key])])
        out += _prom_lines(
            f"{p}_nodes", "gauge", "nodes by scheduling state",
            [(f'{{state="{s}"}}', snap["nodes"][s])
             for s in ("active", "draining", "down")])
        if snap.get("mttf_window_h") is not None:
            out += _prom_lines(f"{p}_mttf_window_hours", "gauge",
                               "rolling windowed MTTF",
                               [("", snap["mttf_window_h"])])
        if snap.get("ettr_window") is not None:
            out += _prom_lines(f"{p}_ettr_window", "gauge",
                               "windowed online ETTR proxy",
                               [("", snap["ettr_window"])])
        for key, unit_name, scale in (
                ("detect_lag_s", f"{p}_detect_lag_seconds", 1.0),
                ("sched_pass_ms", f"{p}_sched_pass_seconds", 1e-3)):
            summ = snap.get(key)
            if summ:
                samples = [(f'{{quantile="{q}"}}', summ[f"p{qk}"] * scale)
                           for q, qk in (("0.5", "50"), ("0.9", "90"),
                                         ("0.99", "99"))]
                out += _prom_lines(unit_name, "summary",
                                   f"windowed {key} percentiles", samples)
    return "\n".join(out) + "\n"


# -- wall-clock heartbeat channel -------------------------------------------
class Heartbeat:
    """Per-cell progress heartbeats for a worker-pool grid.

    Fold each completed cell in via :meth:`on_cell` (from the
    ``run_cells`` ``on_result`` callback — the existing result queue is
    the transport); each beat carries done/total, elapsed, ETA, and
    pool efficiency (sum of in-worker cell walls over ``elapsed x
    procs`` — 1.0 means the pool never idled), optionally printed as a
    one-line progress message and/or streamed to a jsonl file.
    """

    def __init__(self, total: int, procs: int, *,
                 print_fn: Optional[Callable[[str], None]] = None,
                 jsonl_path: Optional[str] = None,
                 phase_totals: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.total = total
        self.procs = max(1, procs)
        self.done = 0
        self.cell_wall_sum = 0.0
        # ``phase_totals`` (phase name -> expected cell count) enables a
        # cost-aware ETA for heterogeneous grids: under the fork plan a
        # grid mixes probe-carrying "prefix" cells with near-free
        # "suffix" cells, and the naive done/elapsed rate whipsaws when
        # the cheap suffixes land first.  Budgeting each phase's
        # remaining cells at that phase's own mean wall keeps the ETA
        # steady.
        self.phase_totals = dict(phase_totals) if phase_totals else None
        self._phase_done: dict = {}
        self._phase_wall: dict = {}
        # cell-cache channel: populated only when the caller marks cells
        # as cached=True/False (a grid running with a cell cache); beats
        # then carry running hit/miss counts
        self.cache_hits = 0
        self.cache_misses = 0
        self._cache_seen = False
        self._clock = clock
        self._t0 = clock()
        self._print = print_fn
        self._writer = JsonlWriter(jsonl_path) if jsonl_path else None

    def _phase_eta_s(self) -> Optional[float]:
        """Remaining-work ETA from per-phase mean cell walls (None when
        no ``phase_totals`` were declared).  Phases with no completed
        sample yet are budgeted at the costliest observed phase mean (a
        deliberately conservative stand-in: the cheap phases finish
        first under the fork plan), or the overall mean before any
        sample exists."""
        if not self.phase_totals:
            return None
        overall = self.cell_wall_sum / max(self.done, 1)
        means = {p: self._phase_wall[p] / n
                 for p, n in self._phase_done.items() if n}
        fallback = max(means.values()) if means else overall
        work = 0.0
        for p, tot in self.phase_totals.items():
            rem = max(tot - self._phase_done.get(p, 0), 0)
            work += rem * means.get(p, fallback)
        # cells outside any declared phase fall back to the overall mean
        undeclared = self.total - sum(self.phase_totals.values())
        if undeclared > 0:
            phased_done = sum(self._phase_done.values())
            work += max(undeclared - (self.done - phased_done), 0) * overall
        return work / self.procs

    def on_cell(self, label: str, wall_s: float,
                phase: Optional[str] = None,
                cached: Optional[bool] = None) -> dict:
        """Fold one completed cell; returns (and emits) the beat.
        ``cached`` (tri-state) marks cell-cache hits/misses — pass
        ``wall_s=0.0`` for a hit so pool efficiency stays honest."""
        self.done += 1
        self.cell_wall_sum += wall_s
        if cached is not None:
            self._cache_seen = True
            if cached:
                self.cache_hits += 1
            else:
                self.cache_misses += 1
        if phase is not None:
            self._phase_done[phase] = self._phase_done.get(phase, 0) + 1
            self._phase_wall[phase] = (self._phase_wall.get(phase, 0.0)
                                       + wall_s)
        elapsed = max(self._clock() - self._t0, 1e-9)
        rate = self.done / elapsed                      # cells/sec, pool-wide
        remaining = self.total - self.done
        eta_s = self._phase_eta_s()
        if eta_s is None:
            eta_s = remaining / rate
        efficiency = min(self.cell_wall_sum / (elapsed * self.procs), 1.0)
        beat = {
            "kind": "heartbeat",
            "done": self.done,
            "total": self.total,
            "label": label,
            "cell_wall_s": round(wall_s, 3),
            "elapsed_s": round(elapsed, 3),
            "eta_s": round(eta_s, 1),
            "cells_per_sec": round(rate, 4),
            "procs": self.procs,
            "pool_efficiency": round(efficiency, 3),
        }
        if phase is not None:
            beat["phase"] = phase
        if self._cache_seen:
            beat["cache_hits"] = self.cache_hits
            beat["cache_misses"] = self.cache_misses
        if self._writer is not None:
            self._writer(beat)
        if self._print is not None:
            self._print(self.format_line(beat))
        return beat

    @staticmethod
    def format_line(beat: dict) -> str:
        phase = f" [{beat['phase']}]" if "phase" in beat else ""
        cache = (f"  cache {beat['cache_hits']}h/{beat['cache_misses']}m"
                 if "cache_hits" in beat else "")
        return (f"[{beat['done']:3d}/{beat['total']}] "
                f"{beat['label']:<28s}{phase} "
                f"{beat['cell_wall_s']:6.2f}s  "
                f"eta {beat['eta_s']:6.1f}s  "
                f"{beat['cells_per_sec']:5.2f} cells/s  "
                f"eff {beat['pool_efficiency']:.2f} "
                f"on {beat['procs']} procs{cache}")

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
