"""The port's seed x scale ensemble (``repro_torch.ensemble``) against the
JAX package's on the CPU: the CLI's ``--json`` on a 2-scale x 2-seed grid
with what-if episodes and a scenario pack, the cell cache (a warm repeat
answers from it; a directory shared with the reference never answers
across packages), and the batched analytic bands, whose torch tier
(``stat_grid``'s plain version with ``device="cpu"``) holds the closed
form within 5e-4 of numpy and gives ``oracle_bracket`` the same verdicts.
Without a card, ``--analytic-bands`` stops with "no CUDA device". With
``--progress`` / ``--heartbeat`` the CLI's beats are the reference's less
their wall-clock fields, and neither it nor its workers import torch.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.ensemble import run as r_run
from repro.ensemble.aggregate import EnsembleAggregator as REnsembleAggregator
from repro.ensemble.runner import CellStats as RCellStats
from repro_torch.core import backend as tbk
from repro_torch.ensemble import run as t_run
from repro_torch.ensemble.aggregate import EnsembleAggregator
from repro_torch.ensemble.runner import CellStats
from repro_torch.obs import read_jsonl
from tests.test_torch_mitigations import obs_flag_runs, same, timeless

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NO_CUDA = {"CUDA_VISIBLE_DEVICES": ""}
GRID = ["--gpus", "256,512", "--seeds", "2", "--days", "5", "--min-hours", "4"]
CLOSED_FORM = ("ettr", "n_failures", "dt_s", "mttf_hours")


def cli(pkg, args, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", f"{pkg}.ensemble.run", *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def grid_json(tmp_path_factory):
    """The reference's and the port's --json on the same grid (episodes,
    a scenario pack, the spawn pool, numpy bands)."""
    d = tmp_path_factory.mktemp("ens")
    args = GRID + ["--episodes", "rf:2@4,outage:16@4", "--scenario", "rack-correlated",
                   "--procs", "2", "--analytic-bands", "--stat-backend", "numpy"]
    out = {}
    for pkg in ("repro", "repro_torch"):
        r = cli(pkg, args + ["--json", str(d / f"{pkg}.json")])
        assert r.returncode == 0, r.stdout + r.stderr
        out[pkg] = json.loads((d / f"{pkg}.json").read_text())
    return out


def test_ensemble_cli_json_equals_reference(grid_json):
    got, want = grid_json["repro_torch"], grid_json["repro"]
    assert got["n_cells"] == 4 and sorted(got["episodes"]) == ["outage:16@4", "rf:2@4"]
    assert same(timeless(got), timeless(want))


def test_cell_cache_answers_repeats_and_never_across_packages(tmp_path):
    cache = ["--cache", str(tmp_path / "cc"), "--procs", "0"]
    small = ["--gpus", "256", "--seeds", "2", "--days", "2", "--min-hours", "4"]

    def run(pkg, name):
        r = cli(pkg, small + cache + ["--json", str(tmp_path / name)])
        assert r.returncode == 0, r.stdout + r.stderr
        return json.loads((tmp_path / name).read_text())

    ref = run("repro", "r.json")
    cold = run("repro_torch", "t1.json")
    warm = run("repro_torch", "t2.json")
    ref_again = run("repro", "r2.json")
    assert ref["cache"]["hits"] == 0 and ref["cache"]["misses"] == 2
    assert cold["cache"]["hits"] == 0 and cold["cache"]["misses"] == 2
    assert warm["cache"]["hits"] == 2 and warm["cache"]["misses"] == 0
    assert ref_again["cache"]["hits"] == 2
    lines = (tmp_path / "cc" / "cells.jsonl").read_text().splitlines()
    assert len(lines) == 4 and len({json.loads(x)["key"] for x in lines}) == 4
    for a in (cold, warm, ref_again):
        a.pop("cache"), a.pop("wall_s")
    ref.pop("cache"), ref.pop("wall_s")
    assert same(timeless(cold), timeless(ref)) and same(warm, cold)


def aggregators(cells):
    """The same cells in the port's and the reference's aggregator."""
    t, r = EnsembleAggregator(), REnsembleAggregator()
    for c in cells:
        t.add(CellStats(**c))
        r.add(RCellStats(**c))
    return t, r


def test_batched_analytic_bands_torch_against_numpy(grid_json):
    tagg, ragg = aggregators(grid_json["repro_torch"]["cells"])
    want_bands, want = r_run.batched_analytic_bands(ragg, r_f_nominal=6.5e-3,
                                                    backend="numpy", include_mc=True)
    np_bands, got_np = t_run.batched_analytic_bands(tagg, r_f_nominal=6.5e-3,
                                                    backend="numpy", include_mc=True)
    bands, got = t_run.batched_analytic_bands(tagg, r_f_nominal=6.5e-3, backend="torch",
                                              include_mc=True, device="cpu")
    assert got.backend is tbk.StatBackend.TORCH and got.n_compiled_calls == 1
    assert got.grid.shape == (1, 2, 2)
    for k in CLOSED_FORM + ("mc_ettr_mean", "mc_ettr_std", "mc_n_failures"):
        assert np.array_equal(getattr(got_np, k), getattr(want, k)), k
    for k in CLOSED_FORM:
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=5e-4, atol=0,
                                   err_msg=k)
    # the Monte-Carlo draws from other streams: in distribution only
    assert np.all(np.abs(got.mc_ettr_mean - want.mc_ettr_mean) < 0.06)
    for g in tagg.scales():
        ok, mean, band = t_run.oracle_bracket(tagg, bands, g)
        r_ok, r_mean, r_band = r_run.oracle_bracket(ragg, want_bands, g)
        assert ok == r_ok and mean == r_mean
        assert band.lo == pytest.approx(r_band.lo, rel=5e-4)
        assert band.hi == pytest.approx(r_band.hi, rel=5e-4)
        assert vars(t_run.oracle_bracket(tagg, np_bands, g)[2]) == vars(r_band)


def test_ensemble_cli_never_hides_the_card(tmp_path):
    args = ["--gpus", "256", "--seeds", "1", "--days", "1", "--min-hours", "4",
            "--procs", "0", "--analytic-bands"]
    r = cli("repro_torch", args, env_extra=NO_CUDA)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "cells in" not in r.stdout          # it stopped before the replays
    r = cli("repro_torch", args + ["--device", "cpu", "--bands-json",
                                   str(tmp_path / "b.json")], env_extra=NO_CUDA)
    assert r.returncode == 0, r.stderr
    assert "batched analytical bands at fitted rates (TORCH" in r.stdout
    bands = json.loads((tmp_path / "b.json").read_text())
    assert bands["backend"] == "torch" and bands["stat_grid_launches"] == 0
    grid = tbk.grid_from_json(bands)
    assert grid.shape == (1, 1, 1) and grid.gpus == (256,)


@pytest.mark.parametrize("mode", ["progress", "heartbeat", "cache"])
def test_ensemble_obs_flags_equal_reference(tmp_path, mode):
    """--progress / --heartbeat on the port's ensemble give the reference's
    beats: cell labels (episodes included), done / total and phases
    ("prefix" replays, "suffix" episode forks, "cached" from a warm cell
    cache). Only the walls differ."""
    args = ["--gpus", "256,512", "--seeds", "2", "--days", "2", "--min-hours", "4",
            "--episodes", "rf:2@1"]
    got = obs_flag_runs(cli, tmp_path, args, mode)["repro_torch"]
    assert len(got) == 8
    if mode == "progress":
        assert got[:2] == [("1", "8", "256gpu/seed0", "[prefix]"),
                           ("2", "8", "256gpu/seed0/rf:2@1", "[suffix]")]


def test_replay_workers_never_import_torch():
    """What a spawned grid worker imports (replay, scoring on the NUMPY
    tier, the cadence policies' checkpoint manager) leaves torch unloaded;
    the parent loads it only for the bands."""
    code = (
        "import sys\n"
        "import repro_torch.checkpoint.manager, repro_torch.ensemble.run\n"
        "import repro_torch.mitigations.policies, repro_torch.mitigations.sweep\n"
        "from repro_torch.ensemble.runner import ReplayCell, run_replay_cell\n"
        "from repro_torch.mitigations.sweep import run_cell\n"
        "run_replay_cell(ReplayCell(n_gpus=256, seed=0, horizon_days=1.0, min_hours=2.0))\n"
        "c = run_cell('checkpoint_adaptive', 256, 0, horizon_days=2.0, min_hours=2.0)\n"
        "assert c.n_runs_measured > 0\n"
        "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_STAT_BACKEND="torch", **NO_CUDA)
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("pkg_cli", ["ensemble.run", "mitigations.sweep"])
def test_grid_clis_with_progress_never_import_torch(tmp_path, pkg_cli):
    """With --progress and --heartbeat on, neither a grid CLI nor its
    spawned workers (which inherit PYTHONPATH) import torch: a stand-in
    ``torch`` first on the path records any import and fails it."""
    fake = tmp_path / "poison" / "torch"
    fake.mkdir(parents=True)
    mark = tmp_path / "torch-imported"
    (fake / "__init__.py").write_text(
        "import os\n"
        "with open(os.environ['TORCH_IMPORT_MARK'], 'a') as f:\n"
        "    f.write(f'{os.getpid()}\\n')\n"
        "raise ImportError('torch imported by a replay process')\n")
    args = {"ensemble.run": ["--gpus", "256,512", "--seeds", "2", "--days", "2",
                             "--min-hours", "4"],
            "mitigations.sweep": ["--policies", "baseline,checkpoint_adaptive",
                                  "--gpus", "256,512", "--seeds", "1", "--days", "2",
                                  "--min-hours", "2"]}[pkg_cli]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(fake.parent),
                                                       os.path.join(ROOT, "src")]),
               TORCH_IMPORT_MARK=str(mark), **NO_CUDA)
    r = subprocess.run([sys.executable, "-m", f"repro_torch.{pkg_cli}", *args, "--procs", "2",
                        "--progress", "--heartbeat", str(tmp_path / "hb.jsonl")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert not mark.exists(), mark.read_text()
    assert "eta" in r.stdout and len(read_jsonl(str(tmp_path / "hb.jsonl"))) == 4
