"""Engine self-profiler: event-loop phase timers for ``ClusterSim``.

``cProfile`` answers "which function is hot" but costs 2-4x wall and
cannot run on a production replay; the :class:`EngineProfiler` instead
wraps the engine's half-dozen phase entry points (scheduling passes,
fault handling, allocation attempts, record appends, job releases) with
plain ``perf_counter`` pairs — a few percent of overhead — and reports
an event-loop breakdown (calls, total/mean wall, share of run) as a
table or dict.

Attach *before* ``run()``::

    sim = ClusterSim(spec, horizon_days=6)
    prof = EngineProfiler().attach(sim)
    sim.run()
    print(prof.render())

Wrapping is per-instance (an instance attribute shadows the class
method), which survives the engine's hot-loop hoisting: the loop reads
``self._schedule_pass`` / ``self._handle_fault`` at dispatch time, and
``_schedule_pass`` re-reads ``self._alloc_nodes`` / ``self._start_job``
at pass start.  Timers are **inclusive** — ``alloc`` time is also
inside ``sched_pass``, and everything is inside ``total_run`` — so
shares are reported against ``total_run`` and do not sum to 100%.

The profiler is wall-clock-only instrumentation: it never touches
engine RNG or events, so a profiled run stays bit-identical (same
pure-observer contract as ``MetricsRegistry``; the digest gate in
tests/test_obs.py covers an attached profiler too).
"""
from __future__ import annotations

from time import perf_counter
from typing import Optional

__all__ = ["EngineProfiler"]

# (phase label, ClusterSim method name) — inclusive timers; alloc nests
# inside sched_pass, release inside fault/finish handling
_PHASES = (
    ("sched_pass", "_schedule_pass"),
    ("fault", "_handle_fault"),
    ("alloc", "_alloc_nodes"),
    ("record", "_record"),
    ("release", "_end_job"),
)
_TOTAL = "total_run"


class EngineProfiler:
    """Phase timers over one ``ClusterSim`` run (see module docstring)."""

    def __init__(self):
        self.calls: dict[str, int] = {}
        self.wall_s: dict[str, float] = {}
        for label, _ in _PHASES:
            self.calls[label] = 0
            self.wall_s[label] = 0.0
        self.calls[_TOTAL] = 0
        self.wall_s[_TOTAL] = 0.0
        self._sim = None

    def attach(self, sim) -> "EngineProfiler":
        """Shadow the engine's phase methods on *this instance* with
        timed wrappers.  Call before ``sim.run()``; returns self."""
        if self._sim is not None:
            raise ValueError("EngineProfiler is single-use: attach a "
                             "fresh profiler per run")
        self._sim = sim
        calls = self.calls
        wall = self.wall_s

        def timed(label: str, fn):
            def wrapper(*a, **kw):
                t0 = perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    wall[label] += perf_counter() - t0
                    calls[label] += 1
            return wrapper

        for label, name in _PHASES:
            setattr(sim, name, timed(label, getattr(sim, name)))
        sim.run = timed(_TOTAL, sim.run)
        return self

    def detach(self) -> None:
        """Restore the class methods (drop the instance shadows)."""
        sim = self._sim
        if sim is None:
            return
        for _, name in _PHASES:
            sim.__dict__.pop(name, None)
        sim.__dict__.pop("run", None)
        self._sim = None

    # -- reporting -------------------------------------------------------
    def summary(self) -> dict:
        """{phase: {calls, wall_s, mean_us, share_of_run}} plus an
        ``other`` row (main-loop dispatch, heap ops, arrival feed — run
        time not inside any timed phase)."""
        total = self.wall_s[_TOTAL]
        out: dict[str, dict] = {}
        top_level = 0.0   # non-nested phases only (alloc ⊂ sched_pass)
        for label, _ in _PHASES:
            n = self.calls[label]
            w = self.wall_s[label]
            out[label] = {
                "calls": n,
                "wall_s": round(w, 4),
                "mean_us": round(w / n * 1e6, 2) if n else None,
                "share_of_run": round(w / total, 4) if total else None,
            }
            if label != "alloc":
                top_level += w
        out[_TOTAL] = {"calls": self.calls[_TOTAL],
                       "wall_s": round(total, 4),
                       "mean_us": None, "share_of_run": 1.0}
        if total > 0:
            out["other"] = {"calls": None,
                            "wall_s": round(max(total - top_level, 0.0), 4),
                            "mean_us": None,
                            "share_of_run": round(
                                max(total - top_level, 0.0) / total, 4)}
        return out

    def render(self) -> str:
        """The summary as an aligned text table."""
        rows = self.summary()
        lines = ["engine self-profile (inclusive timers; alloc nests "
                 "inside sched_pass)",
                 f"  {'phase':<12} {'calls':>10} {'wall_s':>10} "
                 f"{'mean_us':>10} {'share':>7}"]
        for label, r in rows.items():
            calls = "-" if r["calls"] is None else str(r["calls"])
            mean = "-" if r["mean_us"] is None else f"{r['mean_us']:.1f}"
            share = ("-" if r["share_of_run"] is None
                     else f"{r['share_of_run'] * 100:5.1f}%")
            lines.append(f"  {label:<12} {calls:>10} {r['wall_s']:>10.3f} "
                         f"{mean:>10} {share:>7}")
        return "\n".join(lines)
