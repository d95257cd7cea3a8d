"""Render a recorded obs jsonl stream as a timeline table.

  PYTHONPATH=src python -m repro_torch.obs.report RUN.jsonl
  PYTHONPATH=src python -m repro_torch.obs.report RUN.jsonl --last
  PYTHONPATH=src python -m repro_torch.obs.report BEATS.jsonl   # heartbeats

Both stream kinds live in the same jsonl container discriminated by the
``kind`` field: ``snapshot`` rows (simulated-time metrics from a
``MetricsRegistry``) render as a timeline table, ``heartbeat`` rows
(wall-clock worker-pool progress) replay as per-cell progress lines.
"""
from __future__ import annotations

import argparse

from repro_torch.obs.emit import Heartbeat, read_jsonl


def _fmt(v, width: int, prec: int = 2) -> str:
    if v is None:
        return "-".rjust(width)
    if isinstance(v, float):
        return f"{v:.{prec}f}".rjust(width)
    return str(v).rjust(width)


def snapshot_table(snaps: list[dict]) -> str:
    """The snapshot stream as one aligned timeline table (a row per
    snapshot; the columns a live dashboard would plot)."""
    header = (f"{'t_days':>7} {'queue':>6} {'run':>6} {'gpu%':>6} "
              f"{'down':>5} {'drain':>5} {'faults':>7} {'mttf_h':>8} "
              f"{'ettr':>6} {'det_p50s':>8} {'pass_p99ms':>10} "
              f"{'d/s':>7}")
    lines = [header, "-" * len(header)]
    for s in snaps:
        det = s.get("detect_lag_s") or {}
        pw = s.get("sched_pass_ms") or {}
        util = s.get("gpu_util")
        lines.append(" ".join([
            _fmt(s.get("t_days"), 7),
            _fmt(s.get("queue_depth"), 6),
            _fmt(s.get("running_jobs"), 6),
            _fmt(util * 100 if util is not None else None, 6, 1),
            _fmt(s.get("nodes", {}).get("down"), 5),
            _fmt(s.get("nodes", {}).get("draining"), 5),
            _fmt(s.get("faults_total"), 7),
            _fmt(s.get("mttf_window_h"), 8, 1),
            _fmt(s.get("ettr_window"), 6, 3),
            _fmt(det.get("p50"), 8, 1),
            _fmt(pw.get("p99"), 10, 3),
            _fmt(s.get("sim_days_per_wall_s"), 7, 1),
        ]))
    return "\n".join(lines)


def summarize_final(snap: dict) -> str:
    lines = [f"final snapshot @ t={snap.get('t_days')} days:"]
    for k in ("jobs_total", "job_states", "faults_total", "fault_domains",
              "fault_rate_window_per_1000_node_days", "drains_total",
              "repairs_total", "mttf_window_h", "ettr_window",
              "sched_passes_total", "jobs_started_total",
              "preemptions_total", "sim_days_per_wall_s"):
        if k in snap:
            lines.append(f"  {k:40} {snap[k]}")
    if "sources" in snap:
        for name, vals in snap["sources"].items():
            lines.append(f"  sources.{name:32} {vals}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="timeline table from an obs snapshot/heartbeat "
                    "jsonl stream")
    ap.add_argument("stream", help="jsonl path (from --obs-out or "
                                   "--heartbeat)")
    ap.add_argument("--last", action="store_true",
                    help="print only the final snapshot, expanded")
    args = ap.parse_args(argv)

    rows = read_jsonl(args.stream)
    snaps = [r for r in rows if r.get("kind") == "snapshot"]
    beats = [r for r in rows if r.get("kind") == "heartbeat"]
    if not snaps and not beats:
        raise SystemExit(f"{args.stream}: no snapshot/heartbeat rows "
                         f"({len(rows)} other records)")
    if snaps:
        if args.last:
            print(summarize_final(snaps[-1]))
        else:
            print(f"{len(snaps)} snapshots from {args.stream}\n")
            print(snapshot_table(snaps))
            print()
            print(summarize_final(snaps[-1]))
    if beats:
        print(f"{len(beats)} heartbeats from {args.stream}\n")
        for b in (beats[-1:] if args.last else beats):
            print(Heartbeat.format_line(b))
        last = beats[-1]
        print(f"\n{last['done']}/{last['total']} cells in "
              f"{last['elapsed_s']:.1f}s on {last['procs']} procs, "
              f"pool efficiency {last['pool_efficiency']:.2f}")


if __name__ == "__main__":
    main()
