"""Trace layer: structured event traces as the simulator's first-class
output, plus external-trace ingestion.

  * ``schema``   — columnar repro-trace/v1 tables + the ``Trace`` object
  * ``store``    — chunked columnar append stores (the engine's logs)
                   with streaming npz spill parts (constant-RSS mode)
  * ``recorder`` — ``TraceRecorder``, the scheduler's zero-overhead-when-off
                   trace hook; ``simulate_trace`` for record->analyze runs
  * ``io``       — npz / jsonl round-trip persistence + lazy spill-
                   directory loading (``trace_io.load(DIR)``)
  * ``ingest``   — Philly-style CSV job tables -> ``Trace``
  * ``report``   — ``python -m repro_torch.trace.report TRACE``: the full
                   Fig. 3-9 metric table from any trace

See docs/trace_schema.md for the schema reference.
"""
from repro_torch.trace.ingest import ingest_philly_csv
from repro_torch.trace.recorder import TraceRecorder, simulate_trace
from repro_torch.trace.schema import NO_JOB, SCHEMA, TABLES, Trace

__all__ = ["NO_JOB", "SCHEMA", "TABLES", "Trace", "TraceRecorder",
           "ingest_philly_csv", "simulate_trace"]
