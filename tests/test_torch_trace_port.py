"""The port's trace layer against the JAX package's on the CPU: traces
written by either package load in the other unchanged (npz, jsonl and the
chunked spill directory), the Philly CSV ingests to equal tables, and the
§III report (``trace.report``) gives equal JSON on a saved trace and on
a simulated run under a scenario pack, and its telemetry flags
(``--obs-out``, ``--prom-out``, ``--self-profile``) the reference's
streams less their wall-clock fields.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.cluster.scheduler import ClusterSim as RClusterSim
from repro.cluster.workload import ClusterSpec as RClusterSpec
from repro.trace import TraceRecorder as RTraceRecorder
from repro.trace import ingest_philly_csv as r_ingest
from repro.trace import io as r_io
from repro.trace.report import compute_report as r_report
from repro_torch.cluster.scheduler import ClusterSim
from repro_torch.cluster.workload import ClusterSpec
from repro_torch.trace import TraceRecorder, ingest_philly_csv
from repro_torch.trace import io as t_io
from repro_torch.trace.report import compute_report
from repro_torch.trace.schema import TABLES

SPEC = dict(name="RSC-1", n_nodes=80, jobs_per_day=320.0, target_utilization=0.83, r_f=0.08)
KW = dict(horizon_days=4.0, seed=2, scenario="lablup-504")
PHILLY_CSV = os.path.join(os.path.dirname(__file__), "data", "philly_mini.csv")
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def tables_equal(a, b):
    assert a.meta == b.meta
    for table, cols in TABLES.items():
        for col, _ in cols:
            x, y = a.column(table, col), b.column(table, col)
            assert x.dtype.kind == y.dtype.kind and np.array_equal(x, y), (table, col)


def record(port: bool, spill_dir=None):
    """One small recorded run in either package; returns its trace."""
    if port:
        rec = TraceRecorder(trace_spill_dir=spill_dir)
        sim = ClusterSim(ClusterSpec(**SPEC), **KW, recorder=rec)
    else:
        rec = RTraceRecorder(trace_spill_dir=spill_dir)
        sim = RClusterSim(RClusterSpec(**SPEC), **KW, recorder=rec)
    sim.run()
    return rec.finalize(sim)


@pytest.mark.parametrize("suffix", [".npz", ".jsonl"])
def test_saved_traces_interchange(tmp_path, suffix):
    port, ref = record(True), record(False)
    tables_equal(port, ref)
    t_path = t_io.save(port, str(tmp_path / f"port{suffix}"))
    r_path = r_io.save(ref, str(tmp_path / f"ref{suffix}"))
    tables_equal(r_io.load(t_path), ref)      # the port's file in the reference
    tables_equal(t_io.load(r_path), port)     # the reference's file in the port
    if suffix == ".npz":
        with open(t_path, "rb") as f, open(r_path, "rb") as g:
            assert f.read() == g.read()


def test_spill_directories_interchange(tmp_path):
    t_dir, r_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    port, ref = record(True, t_dir), record(False, r_dir)
    tables_equal(port, ref)
    parts = sorted(os.listdir(t_dir))
    assert parts == sorted(os.listdir(r_dir)) and len(parts) > 1
    tables_equal(r_io.load(t_dir), ref)
    tables_equal(t_io.load(r_dir), port)


def test_philly_ingest_equal_tables():
    port, ref = ingest_philly_csv(PHILLY_CSV), r_ingest(PHILLY_CSV)
    assert port.n_rows("jobs") == 9
    tables_equal(port, ref)


def test_report_equal_on_saved_traces(tmp_path):
    path = r_io.save(record(False), str(tmp_path / "ref.npz"))
    want = r_report(r_io.load(path))
    got = compute_report(t_io.load(path))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    csv_kw = dict(min_gpus=16, min_hours=1.0)
    assert json.dumps(compute_report(ingest_philly_csv(PHILLY_CSV), **csv_kw),
                      sort_keys=True) == json.dumps(
        r_report(r_ingest(PHILLY_CSV), **csv_kw), sort_keys=True)


def report_cli(pkg, args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", f"{pkg}.trace.report", *args], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r


def test_report_cli_simulated_scenario_equal(tmp_path):
    args = ["--simulate", "--scenario", "lablup-504", "--nodes", "60", "--days", "3",
            "--seed", "1"]
    report_cli("repro", args + ["--json", str(tmp_path / "r.json"),
                                "--save", str(tmp_path / "r.npz")])
    out = report_cli("repro_torch", args + ["--json", str(tmp_path / "t.json")])
    assert "Figure 3: job status mix" in out.stdout
    want = json.loads((tmp_path / "r.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == want
    # the reference's saved trace through the port's CLI gives its report too
    report_cli("repro_torch", [str(tmp_path / "r.npz"), "--json", str(tmp_path / "t2.json")])
    assert json.loads((tmp_path / "t2.json").read_text()) == want


def profile_rows(stdout):
    """The --self-profile table's (phase, calls) rows; the rest of a row
    is read off the host's clock."""
    lines = stdout.splitlines()
    start = lines.index("engine self-profile (inclusive timers; alloc nests "
                        "inside sched_pass)") + 2
    rows = []
    for line in lines[start:]:
        if not line.startswith("  "):
            break
        rows.append(tuple(line.split()[:2]))
    return rows, lines[:start - 2] + lines[start + len(rows):]


@pytest.mark.parametrize("extra", [[], ["--scenario", "lablup-504", "--obs-interval", "2"]],
                         ids=["default", "lablup-504"])
def test_report_obs_flags_equal_reference(tmp_path, extra):
    """--obs-out / --prom-out / --self-profile on the port's report give the
    reference's snapshot stream and Prometheus text less their wall-clock
    fields, the same profile phases and call counts, and the same report."""
    from repro.obs import read_jsonl as r_read_jsonl
    from repro_torch.obs import read_jsonl
    from tests.test_torch_obs import timeless, timeless_prom

    args = ["--simulate", "--nodes", "60", "--days", "3", "--seed", "1", "--self-profile",
            *extra]
    out = {}
    for pkg in ("repro", "repro_torch"):
        obs, prom = tmp_path / f"{pkg}.jsonl", tmp_path / f"{pkg}.prom"
        r = report_cli(pkg, args + ["--obs-out", str(obs), "--prom-out", str(prom)])
        rows, rest = profile_rows(r.stdout.replace(str(tmp_path / pkg), "OUT"))
        out[pkg] = ([timeless(s) for s in r_read_jsonl(str(obs))],
                    timeless_prom(prom.read_text()), rows, rest)
    got, want = out["repro_torch"], out["repro"]
    assert got[0] == want[0] and len(got[0]) >= 8
    assert [timeless(s) for s in read_jsonl(str(tmp_path / "repro.jsonl"))] == want[0]
    assert got[1] == want[1] and "# TYPE repro_jobs_total counter" in got[1]
    assert got[2] == want[2]
    assert [r[0] for r in got[2]] == ["sched_pass", "fault", "alloc", "record", "release",
                                      "total_run", "other"]
    assert got[3] == want[3] and "Prometheus exposition written to OUT.prom" in got[3]


def test_report_obs_flags_need_simulate(tmp_path):
    """Without --simulate the obs flags are refused up front, in both."""
    for pkg in ("repro", "repro_torch"):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        r = subprocess.run([sys.executable, "-m", f"{pkg}.trace.report", "--obs-out",
                            str(tmp_path / "x.jsonl")], env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0 and "only apply to --simulate" in r.stderr
