"""Live observability layer: streaming run metrics, worker heartbeats,
and an engine self-profiler.

Three pieces, one contract (see docs/observability.md):

* :class:`repro_torch.obs.metrics.MetricsRegistry` — online counters / gauges
  / windowed statistics attached to ``ClusterSim`` via the same
  pure-observer contract as ``TraceRecorder``: never consumes engine
  RNG, never pushes events, ``obs=None`` costs one ``is not None``
  check per hook site, and an instrumented run is bit-for-bit identical
  to a bare one (gated against the committed engine digests in
  tests/test_obs.py; overhead <5% gated by ``benchmarks.run --only
  obs_bench``).
* :mod:`repro_torch.obs.emit` — periodic simulated-time snapshot emission to
  structured jsonl and Prometheus text-exposition format, plus the
  wall-clock :class:`~repro_torch.obs.emit.Heartbeat` channel the ensemble /
  sweep worker pools stream per-cell progress over.
* :class:`repro_torch.obs.profiler.EngineProfiler` — engine phase timers
  (event-loop breakdown: sched passes, fault handling, allocation,
  record appends) exposed as a self-profiling summary.

Front door for recorded snapshot streams::

    PYTHONPATH=src python -m repro_torch.obs.report RUN.jsonl
"""
from repro_torch.obs.emit import (Heartbeat, JsonlWriter, read_jsonl,
                                  to_prometheus)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profiler import EngineProfiler

__all__ = ["MetricsRegistry", "EngineProfiler", "Heartbeat",
           "JsonlWriter", "read_jsonl", "to_prometheus"]
