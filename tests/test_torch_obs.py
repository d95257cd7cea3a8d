"""The port's live telemetry (``repro_torch.obs``) against the JAX package's
on the CPU.

Both are plain Python over the same event engine, so every field that is a
function of simulated time must be equal: an instrumented port run keeps
the five engine digests; its snapshots, ``finalize()`` summary, Prometheus
text and ``obs.report`` output equal the reference's on the same run; and
the two packages read each other's jsonl streams. Only the wall-clock
fields differ between two runs (``WALL_KEYS``, and the Prometheus family
built from ``sched_pass_ms``); ``Heartbeat`` takes a clock, so both
packages are driven by one fake clock and their beats compared whole.
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from repro.cluster.scheduler import ClusterSim as RClusterSim
from repro.cluster.scheduler import JobState as RJobState
from repro.cluster.workload import ClusterSpec as RClusterSpec
from repro.obs import emit as r_emit
from repro.obs import metrics as r_metrics
from repro.obs import profiler as r_profiler
from repro_torch.cluster import engine_version as t_ev
from repro_torch.cluster.scheduler import ClusterSim, JobState
from repro_torch.cluster.workload import ClusterSpec
from repro_torch.obs import EngineProfiler, Heartbeat, JsonlWriter, MetricsRegistry
from repro_torch.obs import emit as t_emit
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import read_jsonl, to_prometheus
from repro_torch.obs import profiler as t_profiler
from tests.test_sim_perf import DIGEST_CONFIGS

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# snapshot fields read off the host's clock (obs/metrics.py's _snapshot)
WALL_KEYS = ("wall_s", "sim_days_per_wall_s", "sched_pass_ms")
SMALL = dict(name="RSC-1", n_nodes=80, jobs_per_day=320.0, target_utilization=0.83,
             r_f=6.5e-3)


def timeless(snap):
    return {k: v for k, v in snap.items() if k not in WALL_KEYS}


def timeless_prom(text):
    """Prometheus text less the one family built from wall-clock pass times."""
    return [line for line in text.splitlines() if "_sched_pass_seconds" not in line]


def instrumented(sim_cls, registry_cls, profiler_cls, spec, **kw):
    """A finished run with a registry and a profiler attached, finalized."""
    reg = registry_cls(**kw.pop("reg_kw", {}))
    sim = sim_cls(spec, obs=reg, **kw)
    prof = profiler_cls().attach(sim)
    sim.run()
    return sim, reg, prof, reg.finalize()


def both(spec_kw, reg_kw=None, **kw):
    """The same instrumented run in the reference and in the port."""
    r = instrumented(RClusterSim, r_metrics.MetricsRegistry, r_profiler.EngineProfiler,
                     RClusterSpec(**spec_kw), reg_kw=dict(reg_kw or {}), **kw)
    t = instrumented(ClusterSim, MetricsRegistry, EngineProfiler, ClusterSpec(**spec_kw),
                     reg_kw=dict(reg_kw or {}), **kw)
    return r, t


def assert_registries_equal(r_reg, r_sum, t_reg, t_sum):
    assert len(t_reg.snapshots) == len(r_reg.snapshots) > 0
    for got, want in zip(t_reg.snapshots, r_reg.snapshots):
        assert timeless(got) == timeless(want)
    assert set(t_sum) == set(r_sum)
    for k in t_sum:
        if k == "final":
            assert timeless(t_sum[k]) == timeless(r_sum[k])
        elif k != "sched_wall_total_s":
            assert t_sum[k] == r_sum[k], k
    for attr in ("jobs_total", "state_counts", "faults_total", "fault_domain_counts",
                 "fault_symptom_counts", "drains_total", "repairs_total",
                 "sched_passes_total", "jobs_started_total", "preemptions_total",
                 "queue_depth"):
        assert getattr(t_reg, attr) == getattr(r_reg, attr), attr
    # the passes the engine timed are the same ones; only their walls differ
    assert t_reg._p_acc[4] == r_reg._p_acc[4] and t_reg._pass_stride == r_reg._pass_stride


@pytest.mark.parametrize("name", sorted(t_ev.ENGINE_DIGESTS))
def test_instrumented_run_keeps_digest_and_equals_reference(name):
    """Registry and profiler attached: the port's run still gives the
    committed digest (taken last: the digest draws from the RNG streams),
    and its snapshots, summary and profile counts equal the reference's."""
    spec, kw = t_ev.digest_configs()[name]
    sim, t_reg, t_prof, t_sum = instrumented(ClusterSim, MetricsRegistry, EngineProfiler,
                                             spec, **kw)
    rspec, rkw = DIGEST_CONFIGS[name]
    rsim, r_reg, r_prof, r_sum = instrumented(
        RClusterSim, r_metrics.MetricsRegistry, r_profiler.EngineProfiler, rspec, **rkw)
    assert_registries_equal(r_reg, r_sum, t_reg, t_sum)
    assert t_prof.calls == r_prof.calls and list(t_prof.summary()) == list(r_prof.summary())
    assert t_prof.calls["record"] == sim.n_records == rsim.n_records
    assert t_ev.engine_digest(sim) == t_ev.ENGINE_DIGESTS[name]


@pytest.mark.parametrize("reg_kw,days,scenario", [
    ({}, 6.0, None),
    ({"snapshot_interval_s": 3600.0, "window_s": 6 * 3600.0}, 3.0, None),
    ({"snapshot_interval_s": 4 * 3600.0}, 4.0, "rack-correlated"),
], ids=["default", "hourly", "rack-correlated"])
def test_snapshots_and_finalize_equal_reference(reg_kw, days, scenario):
    (_, r_reg, _, r_sum), (_, t_reg, _, t_sum) = both(
        SMALL, reg_kw, horizon_days=days, seed=3, scenario=scenario)
    assert_registries_equal(r_reg, r_sum, t_reg, t_sum)
    last = t_reg.snapshots[-1]
    assert last["nodes"]["total"] == 80 and last["jobs_total"] == t_reg.jobs_total
    assert t_reg.snapshots[-1]["t"] == r_reg.snapshots[-1]["t"]


def test_registry_and_profiler_are_single_use():
    sim, reg, prof, _ = instrumented(ClusterSim, MetricsRegistry, EngineProfiler,
                                     ClusterSpec(**SMALL), horizon_days=1.0, seed=3)
    with pytest.raises(ValueError, match="reused"):
        ClusterSim(ClusterSpec(**SMALL), horizon_days=1.0, obs=reg).run()
    with pytest.raises(ValueError, match="single-use"):
        prof.attach(sim)
    with pytest.raises(ValueError, match="before bind"):
        MetricsRegistry().finalize()
    with pytest.raises(ValueError, match="> 0"):
        MetricsRegistry(snapshot_interval_s=0)


def test_hooks_driven_directly_equal_reference():
    """The windowed ETTR proxy, fault windows, detection lag and the
    pass histogram, fed the same hook calls in both packages."""
    regs = []
    for reg_cls, states in ((r_metrics.MetricsRegistry, RJobState),
                            (MetricsRegistry, JobState)):
        reg = reg_cls(snapshot_interval_s=1e9, window_s=24 * 3600.0)
        reg.on_job_end(1000.0, states.COMPLETED, 1, 900.0, False)
        reg.on_job_end(1300.0, states.NODE_FAIL, 1, 1000.0, False)
        reg.on_job_end(1400.0, states.FAILED, 2, 1000.0, True)
        reg.on_job_end(1500.0, states.FAILED, 2, 1000.0, False)
        reg.on_fault(SimpleNamespace(t=100.0, domain="rack:7", symptom="ib_link_error",
                                     detected_t=160.0))
        reg.on_fault(SimpleNamespace(t=200.0, domain=None, symptom="gpu_memory_errors",
                                     detected_t=200.0))
        for i in range(200):
            reg.on_sched_pass(float(i), 3, i % 2, int(i % 5 == 0), False,
                              -1.0 if i % 4 else 1e-6 * (1 + i))
        reg.on_node_down(5.0, 1, "drain")
        reg.on_node_up(9.0, 1)
        ettr = reg.ettr_window()
        reg._edge(reg._jb_end)
        rolled = reg.ettr_window()
        reg._trim(reg._jb_end + 25 * 3600.0)
        regs.append((ettr, rolled, reg.ettr_window(), reg.jobs_total, reg.state_counts,
                     dict(reg.fault_domain_counts), dict(reg.fault_symptom_counts),
                     reg._det_lag.summary(), reg._pass_hist, list(reg._p_acc),
                     reg.drains_total, reg.repairs_total, reg.sched_wall_total_s))
    assert regs[0] == regs[1]
    # lost: the NODE_FAIL attempt and the hw-attributed FAILED one
    assert regs[1][0] == pytest.approx((100 + 1000) / (100 + 300 + 800 + 1000))


def test_histograms_and_percentiles_equal_reference():
    assert t_metrics.INFRA_LOSS_STATES == r_metrics.INFRA_LOSS_STATES
    assert t_metrics._MID == r_metrics._MID and t_metrics._HIST_SLOTS == r_metrics._HIST_SLOTS
    for i in range(t_metrics._HIST_SLOTS):
        assert t_metrics._bucket_upper_ms(i) == r_metrics._bucket_upper_ms(i)
    hist = [(i * 7) % 5 for i in range(t_metrics._HIST_SLOTS)]
    assert t_metrics._hist_stats(hist, sum(hist), 0.37) == r_metrics._hist_stats(
        hist, sum(hist), 0.37)
    assert t_metrics._hist_stats([0] * 8, 0, 0.0) is None
    vals = [((i * 37) % 101) / 7.0 for i in range(250)]
    assert t_metrics._summary(vals, scale=2.0) == r_metrics._summary(vals, scale=2.0)
    for q in (0.0, 12.5, 50.0, 99.0, 100.0):
        assert t_metrics._percentile(sorted(vals), q) == r_metrics._percentile(sorted(vals), q)
    out = []
    for cls in (r_metrics.WindowedHistogram, t_metrics.WindowedHistogram):
        h = cls(window_s=100.0)
        for i in range(10):
            h.add(float(i * 20), float(i))
        h.trim(200.0)
        out.append((len(h), h.values(), h.summary(scale=2.0), cls(10.0).summary()))
    assert out[0] == out[1] and out[1][0] == 5


def test_prometheus_equal_reference_less_wall_clock_lines():
    (_, r_reg, _, _), (_, t_reg, _, _) = both(SMALL, horizon_days=3.0, seed=3)
    got, want = to_prometheus(t_reg), r_emit.to_prometheus(r_reg)
    assert timeless_prom(got) == timeless_prom(want)
    assert f"repro_jobs_total {t_reg.jobs_total}" in got
    assert 'repro_nodes{state="active"}' in got
    assert timeless_prom(to_prometheus(t_reg, prefix="x")) == timeless_prom(
        r_emit.to_prometheus(r_reg, prefix="x"))
    # an empty registry renders its counters alone, as the reference's
    assert to_prometheus(MetricsRegistry()) == r_emit.to_prometheus(
        r_metrics.MetricsRegistry())


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_jsonl_streams_read_back_by_either_package(tmp_path, writer):
    path = str(tmp_path / "run.jsonl")
    if writer == "repro":
        reg = r_metrics.MetricsRegistry()
        w = r_emit.JsonlWriter(path)
        sim = RClusterSim(RClusterSpec(**SMALL), horizon_days=3.0, seed=3, obs=reg)
    else:
        reg = MetricsRegistry()
        w = JsonlWriter(path)
        sim = ClusterSim(ClusterSpec(**SMALL), horizon_days=3.0, seed=3, obs=reg)
    with w:
        reg.attach_emitter(w)
        sim.run()
        reg.finalize()
    assert w.n_written == len(reg.snapshots) > 0
    assert read_jsonl(path) == r_emit.read_jsonl(path) == reg.snapshots


def test_corrupt_lines_rejected_as_the_reference(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"kind": "snapshot"}\n\n{"kind": "snaps\n')
    msgs = []
    for read in (r_emit.read_jsonl, read_jsonl):
        with pytest.raises(ValueError, match="bad.jsonl:3") as e:
            read(str(p))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    p.write_text('{"kind": "snapshot"}\n\n')
    assert read_jsonl(str(p)) == r_emit.read_jsonl(str(p)) == [{"kind": "snapshot"}]


HEARTBEAT_CASES = {
    "plain": dict(total=4, procs=2),
    "phased": dict(total=9, procs=3, phase_totals={"prefix": 3, "suffix": 6}),
    "undeclared": dict(total=9, procs=3, phase_totals={"prefix": 3, "suffix": 4}),
    "one-proc": dict(total=6, procs=0),
}


@pytest.mark.parametrize("case", sorted(HEARTBEAT_CASES))
def test_heartbeats_equal_under_one_clock(tmp_path, case):
    kw = HEARTBEAT_CASES[case]
    ticks = [0.0, 10.0, 20.0, 30.0, 40.0, 41.5, 60.0, 75.25, 90.0, 130.0]
    runs = []
    for pkg, cls in (("repro", r_emit.Heartbeat), ("repro_torch", Heartbeat)):
        lines = []
        path = str(tmp_path / f"{pkg}.jsonl")
        hb = cls(**kw, print_fn=lines.append, jsonl_path=path, clock=iter(ticks).__next__)
        beats = []
        for i in range(kw["total"]):
            phase = ("prefix" if i % 3 == 0 else "suffix") if "phase_totals" in kw else None
            cached = (i % 4 == 1) if case != "plain" else None
            beats.append(hb.on_cell(f"cell{i}", 0.0 if cached else 7.5 + i,
                                    phase=phase, cached=cached))
        hb.close()
        runs.append((beats, lines, read_jsonl(path)))
    assert runs[0] == runs[1]
    beats = runs[1][0]
    assert beats[-1]["done"] == beats[-1]["total"] == kw["total"]
    assert runs[1][2] == beats
    if case != "undeclared":      # cells outside the declared phases keep an ETA
        assert beats[-1]["eta_s"] == 0.0
    assert [Heartbeat.format_line(b) for b in beats] == runs[1][1]


def test_engine_profiler_labels_counts_and_detach():
    out = []
    for sim_cls, spec_cls, prof_cls in ((RClusterSim, RClusterSpec, r_profiler.EngineProfiler),
                                        (ClusterSim, ClusterSpec, EngineProfiler)):
        sim = sim_cls(spec_cls(**SMALL), horizon_days=3.0, seed=3)
        prof = prof_cls().attach(sim)
        assert "_schedule_pass" in sim.__dict__ and "run" in sim.__dict__
        sim.run()
        s = prof.summary()
        rows = [line.split()[0] for line in prof.render().splitlines()[2:]]
        prof.detach()
        assert not {"_schedule_pass", "_handle_fault", "_alloc_nodes", "_record",
                    "_end_job", "run"} & set(sim.__dict__)
        assert sim.run.__func__ is sim_cls.run
        prof.detach()   # a second detach is a no-op
        out.append((dict(prof.calls), list(s), {k: v["calls"] for k, v in s.items()}, rows,
                    sim.n_records))
    assert out[0] == out[1]
    calls = out[1][0]
    assert calls["record"] == out[1][4] and calls["total_run"] == 1 and calls["sched_pass"] > 0
    assert t_profiler._PHASES == r_profiler._PHASES


def obs_report(pkg, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", f"{pkg}.obs.report", *args], env=env,
                          capture_output=True, text=True, timeout=120)


def test_obs_report_cli_prints_what_the_reference_prints(tmp_path):
    """Snapshot streams written by either package, and a heartbeat
    stream, render to the same text through both report CLIs."""
    streams = []
    for pkg, reg_cls, sim_cls, spec_cls in (
            ("repro", r_metrics.MetricsRegistry, RClusterSim, RClusterSpec),
            ("repro_torch", MetricsRegistry, ClusterSim, ClusterSpec)):
        path = str(tmp_path / f"{pkg}.jsonl")
        reg = reg_cls(snapshot_interval_s=12 * 3600.0)
        with t_emit.JsonlWriter(path) as w:
            reg.attach_emitter(w)
            sim_cls(spec_cls(**SMALL), horizon_days=2.0, seed=3, obs=reg).run()
            reg.finalize()
        streams.append(path)
    beats = str(tmp_path / "beats.jsonl")
    hb = Heartbeat(total=3, procs=2, jsonl_path=beats,
                   clock=iter([0.0, 1.0, 2.5, 4.0]).__next__)
    for i in range(3):
        hb.on_cell(f"256gpu/seed{i}", 1.25 * i, phase="prefix" if i else None)
    hb.close()
    for path in streams + [beats]:
        for extra in ([], ["--last"]):
            want = obs_report("repro", path, *extra)
            got = obs_report("repro_torch", path, *extra)
            assert want.returncode == got.returncode == 0, want.stderr + got.stderr
            assert got.stdout == want.stdout
    assert "final snapshot" in got.stdout or "cells in" in got.stdout
    empty = tmp_path / "other.jsonl"
    empty.write_text('{"kind": "other"}\n')
    want, got = obs_report("repro", str(empty)), obs_report("repro_torch", str(empty))
    assert got.returncode == want.returncode != 0
    assert got.stderr.splitlines()[-1] == want.stderr.splitlines()[-1]


def test_obs_exports_are_the_reference_exports():
    import repro.obs
    import repro_torch.obs

    assert repro_torch.obs.__all__ == repro.obs.__all__
    assert t_emit.__all__ == r_emit.__all__
