"""Trace-driven §III report: the full Fig. 3-9 metric table from ANY
trace — a simulated replay, a saved npz/jsonl trace, or an ingested
Philly-style CSV job table.

  PYTHONPATH=src python -m repro_torch.trace.report run.npz
  PYTHONPATH=src python -m repro_torch.trace.report jobs.csv            # ingest
  PYTHONPATH=src python -m repro_torch.trace.report run.jsonl --json out.json
  PYTHONPATH=src python -m repro_torch.trace.report --simulate --days 6

Sections degrade gracefully with trace contents: fault-derived figures
(4, 5) are skipped when the faults table is empty (typical for ingested
job tables), and per-capacity normalizations are skipped when the trace
meta does not know the cluster size.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np

from repro_torch.cluster import analysis
from repro_torch.core import mttf_model
from repro_torch.trace import io as trace_io
from repro_torch.trace.ingest import ingest_philly_csv
from repro_torch.trace.schema import Trace


def load_any(path: str, fmt: str = "auto") -> Trace:
    """Load a trace from npz / jsonl (delegating to ``trace_io.load``'s
    suffix dispatch), or ingest a Philly-style CSV."""
    if fmt == "philly" or (fmt == "auto" and path.endswith(".csv")):
        return ingest_philly_csv(path)
    if fmt == "npz":
        return trace_io.load_npz(path)
    if fmt == "jsonl":
        return trace_io.load_jsonl(path)
    if fmt == "auto":
        return trace_io.load(path)
    raise ValueError(f"unknown trace format {fmt!r}")


def compute_report(trace: Trace, *, min_gpus: int = 64,
                   min_hours: float = 12.0,
                   cp_interval_s: float = 3600.0) -> dict:
    """All Fig. 3-9 metrics from one trace, as a nested dict (the CLI
    pretty-prints it; --json dumps it verbatim)."""
    out: dict = {"summary": trace.summary()}

    # Figure 3 + Observation 4
    sb = analysis.status_breakdown(trace)
    out["fig3_status_mix"] = {
        "jobs": {k: round(v, 5) for k, v in sorted(
            sb["jobs"].items(), key=lambda kv: -kv[1])},
        "gpu_time": {k: round(v, 5) for k, v in sorted(
            sb["gpu_time"].items(), key=lambda kv: -kv[1])},
    }
    imp = analysis.hw_impact(trace)
    out["obs4_hw_impact"] = {k: round(v, 6) for k, v in imp.items()}

    # Figure 4 (needs faults/symptoms + capacity normalization)
    if trace.n_gpus is not None and trace.horizon_s is not None:
        rates = analysis.attribution_rates(trace)
        if rates:
            out["fig4_attribution_per_gpu_h"] = {
                k: float(f"{v:.4g}") for k, v in rates.items()}

    # Figure 5 (needs the faults table + node count)
    if trace.n_rows("faults") and trace.n_nodes and trace.horizon_days:
        days, rates = analysis.failure_rate_timeline(trace)
        out["fig5_failure_rate_per_1000_node_days"] = {
            s: {"mean": round(float(r.mean()), 3),
                "peak": round(float(r.max()), 3)}
            for s, r in sorted(rates.items(),
                               key=lambda kv: -kv[1].mean())}

    # Fault-model v2: correlated domains + staged detection (skipped on
    # v1 traces — the optional fault columns degrade to {} rather than
    # KeyError)
    v2 = analysis.domain_detection_summary(trace)
    if v2:
        out["fault_model_v2"] = v2

    # Figure 6
    mix = analysis.job_size_mix(trace)
    out["fig6_job_size_mix"] = {
        int(size): {k: round(v, 5) for k, v in row.items()}
        for size, row in mix.items()}

    # Figure 7 (+ fitted cluster failure rate)
    records = trace.job_records()
    rf = mttf_model.fit_r_f(records, min_gpus=min_gpus)
    curve = {}
    for p in mttf_model.empirical_mttf_curve(records):
        if p.n_failures >= 1:
            curve[int(p.n_gpus)] = {
                "mttf_h": round(p.mttf_hours, 2),
                "ci90_h": [round(p.ci_lo_hours, 2),
                           round(p.ci_hi_hours, 2)],
                "n_failures": int(p.n_failures)}
    out["fig7_mttf_by_size"] = curve
    if rf and math.isfinite(rf) and rf > 0:
        out["fig7_fitted_r_f_per_1000_node_days"] = round(rf * 1000, 3)
        out["fig7_projection_h"] = {
            g: round(mttf_model.projected_mttf_hours(g, rf), 2)
            for g in (16384, 131072)}

    # Figure 8 + Observation 9
    out["fig8_goodput_loss_by_size_gpu_h"] = {
        b: {k: round(v, 2) for k, v in row.items()}
        for b, row in analysis.goodput_loss_by_size(
            trace, assumed_cp_interval=cp_interval_s).items()}
    casc = analysis.preemption_cascades(trace)
    out["obs9_preemption_cascades"] = {
        k: round(v, 4) for k, v in casc.items()}

    # Figure 9 (measured ETTR over qualifying runs)
    ettr_kw = dict(checkpoint_interval=cp_interval_s)
    if rf and math.isfinite(rf) and rf > 0:
        ettr_kw["r_f_per_node_day"] = rf
    rows = analysis.run_ettrs(trace, min_gpus=min_gpus,
                              min_hours=min_hours, **ettr_kw)
    if rows:
        ettrs = [r.ettr for _, r in rows]
        out["fig9_measured_ettr"] = {
            "n_qualifying_runs": len(rows),
            "min_gpus": min_gpus, "min_hours": min_hours,
            "mean": round(float(np.mean(ettrs)), 4),
            "p10": round(float(np.percentile(ettrs, 10)), 4),
            "p90": round(float(np.percentile(ettrs, 90)), 4),
            "mean_queue_share": round(float(np.mean(
                [r.queue / max(r.wallclock, 1e-9) for _, r in rows])), 4),
        }
    else:
        out["fig9_measured_ettr"] = {
            "n_qualifying_runs": 0, "min_gpus": min_gpus,
            "min_hours": min_hours,
            "note": "no runs qualify; lower --min-gpus/--min-hours"}

    # §IV-A headline
    out["lemon_large_job_failure_rate"] = round(
        analysis.large_job_failure_rate(trace, min_gpus=min_gpus), 4)
    return out


def _print_section(title: str, body: dict, indent: int = 2) -> None:
    print(f"\n== {title} ==")
    pad = " " * indent
    for k, v in body.items():
        if isinstance(v, dict):
            inner = ", ".join(f"{ik}={iv}" for ik, iv in v.items())
            print(f"{pad}{k:24} {inner}")
        else:
            print(f"{pad}{k:24} {v}")


_SECTION_TITLES = {
    "summary": "Trace",
    "fig3_status_mix": "Figure 3: job status mix",
    "obs4_hw_impact": "Observation 4: HW failure impact",
    "fig4_attribution_per_gpu_h": "Figure 4: attributed failures /GPU-h",
    "fig5_failure_rate_per_1000_node_days":
        "Figure 5: failure-rate timeline (/1000 node-days)",
    "fault_model_v2": "Fault-model v2: domains + staged detection",
    "fig6_job_size_mix": "Figure 6: job-size mix",
    "fig7_mttf_by_size": "Figure 7: MTTF by job size",
    "fig7_fitted_r_f_per_1000_node_days": "Figure 7: fitted r_f",
    "fig7_projection_h": "Figure 7: MTTF projections (hours)",
    "fig8_goodput_loss_by_size_gpu_h": "Figure 8: goodput loss by size",
    "obs9_preemption_cascades": "Observation 9: preemption cascades",
    "fig9_measured_ettr": "Figure 9: measured ETTR",
    "lemon_large_job_failure_rate": "§IV-A: large-job failure rate",
}


def print_report(report: dict) -> None:
    for key, body in report.items():
        title = _SECTION_TITLES.get(key, key)
        if isinstance(body, dict):
            _print_section(title, body)
        else:
            print(f"\n== {title} ==\n  {body}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Fig. 3-9 metric table from any trace "
                    "(simulated, saved, or ingested)")
    ap.add_argument("trace", nargs="?", default=None,
                    help="trace path: .npz / .jsonl / Philly-style .csv")
    ap.add_argument("--format", default="auto",
                    choices=("auto", "npz", "jsonl", "philly"))
    ap.add_argument("--simulate", action="store_true",
                    help="no input trace: simulate a small RSC-1-like "
                         "cluster, record its trace, and report from it")
    ap.add_argument("--nodes", type=int, default=200,
                    help="--simulate cluster size (nodes)")
    ap.add_argument("--days", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenario", default=None,
                    help="--simulate fault-model v2 scenario pack (see "
                         "repro_torch.configs.scenarios; default: exact-legacy "
                         "independent-v1)")
    ap.add_argument("--min-gpus", type=int, default=64,
                    help="ETTR/MTTF qualifying-run GPU floor")
    ap.add_argument("--min-hours", type=float, default=12.0,
                    help="ETTR qualifying-run total-runtime floor")
    ap.add_argument("--cp-interval", type=float, default=3600.0,
                    help="assumed checkpoint cadence (s) for goodput/ETTR")
    ap.add_argument("--save", default=None,
                    help="also save the (simulated/ingested) trace here "
                         "(.npz or .jsonl)")
    ap.add_argument("--json", default=None,
                    help="dump the metric table as JSON")
    ap.add_argument("--obs-out", default=None,
                    help="--simulate: stream live MetricsRegistry "
                         "snapshots to this jsonl (view with "
                         "python -m repro_torch.obs.report)")
    ap.add_argument("--obs-interval", type=float, default=6.0,
                    help="snapshot cadence in simulated hours")
    ap.add_argument("--prom-out", default=None,
                    help="--simulate: write the final metric state in "
                         "Prometheus text-exposition format")
    ap.add_argument("--self-profile", action="store_true",
                    help="--simulate: print the engine phase-timer "
                         "breakdown after the run")
    args = ap.parse_args(argv)

    if args.simulate and args.trace:
        ap.error("pass a trace path OR --simulate, not both")
    if args.scenario and not args.simulate:
        ap.error("--scenario only applies to --simulate")
    if not args.simulate and (args.obs_out or args.prom_out
                              or args.self_profile):
        ap.error("--obs-out/--prom-out/--self-profile instrument a live "
                 "run: they only apply to --simulate")
    if args.save and not args.save.endswith((".npz", ".jsonl")):
        ap.error(f"--save {args.save!r}: use a .npz or .jsonl suffix "
                 "(checked up front so a long run is not wasted)")
    if args.simulate:
        from repro_torch.cluster.workload import ClusterSpec
        from repro_torch.trace.recorder import simulate_trace

        if args.scenario is not None:
            from repro_torch.configs.scenarios import get_scenario
            try:
                get_scenario(args.scenario)   # fail fast on a bad name
            except KeyError as e:
                ap.error(e.args[0])
        spec = ClusterSpec("RSC-1", n_nodes=args.nodes,
                           jobs_per_day=args.nodes * 3.6,
                           target_utilization=0.83, r_f=6.5e-3)
        obs = writer = profiler = None
        setup = None
        if args.obs_out or args.prom_out:
            from repro_torch.obs import JsonlWriter, MetricsRegistry
            obs = MetricsRegistry(
                snapshot_interval_s=args.obs_interval * 3600.0)
            if args.obs_out:
                writer = JsonlWriter(args.obs_out)
                obs.attach_emitter(writer)
        if args.self_profile:
            from repro_torch.obs import EngineProfiler
            profiler = EngineProfiler()
            setup = profiler.attach
        sim_kw = {} if obs is None else {"obs": obs}
        _, trace = simulate_trace(spec, horizon_days=args.days,
                                  seed=args.seed, scenario=args.scenario,
                                  setup=setup, **sim_kw)
        if obs is not None:
            obs.finalize()
        if writer is not None:
            writer.close()
            print(f"{writer.n_written} obs snapshots streamed to "
                  f"{args.obs_out}")
        if args.prom_out:
            from repro_torch.obs import to_prometheus
            with open(args.prom_out, "w") as f:
                f.write(to_prometheus(obs))
            print(f"Prometheus exposition written to {args.prom_out}")
        if profiler is not None:
            print(profiler.render())
    elif args.trace:
        trace = load_any(args.trace, args.format)
    else:
        ap.error("pass a trace path or --simulate")

    if args.save:
        trace_io.save(trace, args.save)
        print(f"trace saved to {args.save}")

    report = compute_report(trace, min_gpus=args.min_gpus,
                            min_hours=args.min_hours,
                            cp_interval_s=args.cp_interval)
    print_report(report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"\nmetric table written to {args.json}")


if __name__ == "__main__":
    main()
