"""The port's mitigation lab (``repro_torch.mitigations``) against the JAX
package's on the CPU: the policy registry, the sweep's per-cell rows
(forked and cold), the CLI's ``--json``, and the batched what-if table,
whose numpy tier equals the reference's to the bit and whose torch tier
(``stat_grid``'s plain version with ``device="cpu"``) is within 5e-4.
Without a card, ``--analytic-bands`` stops with "no CUDA device". With
``--progress`` / ``--heartbeat`` the CLI's beats are the reference's less
their wall-clock fields.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro.mitigations import policy as r_policy
from repro.mitigations import sweep as r_sweep
from repro_torch.core import backend as tbk
from repro_torch.mitigations import policy as t_policy
from repro_torch.mitigations import sweep as t_sweep
from repro_torch.obs import read_jsonl

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
POLICIES = ("baseline", "lemon_eviction", "checkpoint_optimal", "health_gate")
GPUS = (256, 512)
NO_CUDA = {"CUDA_VISIBLE_DEVICES": ""}
CLOSED_FORM = ("ettr", "n_failures", "dt_s", "mttf_hours")


def timeless(o):
    """A result without its wall-clock fields (every key ending in wall_s)."""
    if isinstance(o, dict):
        return {k: timeless(v) for k, v in o.items() if not k.endswith("wall_s")}
    if isinstance(o, list):
        return [timeless(v) for v in o]
    return o


def same(a, b) -> bool:
    """JSON-level equality with NaN equal to NaN."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# a --progress line: "[  3/8] 256gpu/seed1   [prefix]   0.01s  eta ..."
PROGRESS = re.compile(r"^\s+\[\s*(\d+)/(\d+)\] (\S+)\s+(\[\w+\])?")
BEAT_KEYS = ("kind", "done", "total", "label", "procs", "phase", "cache_hits", "cache_misses")


def progress_of(stdout):
    """The --progress lines' done, total, cell label and phase (the rest
    of a line is read off the host's clock)."""
    return [m.groups() for m in map(PROGRESS.match, stdout.splitlines()) if m]


def beats_of(path):
    """A --heartbeat stream less its wall-clock fields."""
    return [{k: b[k] for k in BEAT_KEYS if k in b} for b in read_jsonl(path)]


def obs_flag_runs(cli, tmp_path, args, mode):
    """The reference's and the port's CLI with one obs flag: ``progress``
    (serial), ``heartbeat`` (a spawn pool of 2) or ``cache`` (a heartbeat
    stream from a warm cell cache). Returns {package: what the flag gave},
    progress lines or beats; a pool's beats come sorted by label, since
    its cells land in any order."""
    out = {}
    for pkg in ("repro", "repro_torch"):
        hb = str(tmp_path / f"{pkg}.jsonl")
        run = args + {"progress": ["--procs", "0", "--progress"],
                      "heartbeat": ["--procs", "2", "--heartbeat", hb],
                      "cache": ["--procs", "0", "--heartbeat", hb,
                                "--cache", str(tmp_path / f"cache-{pkg}")]}[mode]
        for _ in range(2 if mode == "cache" else 1):   # the first fills the cache
            r = cli(pkg, run)
            assert r.returncode == 0, r.stdout + r.stderr
        if mode == "progress":
            out[pkg] = progress_of(r.stdout)
            assert "eta" in r.stdout
            continue
        assert f"heartbeats streamed to {hb}" in r.stdout
        beats = beats_of(hb)
        assert [b["done"] for b in beats] == list(range(1, len(beats) + 1))
        assert beats[-1]["total"] == len(beats)
        if mode == "heartbeat":
            beats = sorted(({k: v for k, v in b.items() if k != "done"} for b in beats),
                           key=lambda b: b["label"])
        else:
            assert {b["phase"] for b in beats} == {"cached"}
            assert beats[-1]["cache_hits"] == len(beats) and beats[-1]["cache_misses"] == 0
        out[pkg] = beats
    assert out["repro_torch"] and out["repro_torch"] == out["repro"]
    return out


def cli(pkg, args, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", f"{pkg}.mitigations.sweep", *args],
                          env=env, capture_output=True, text=True, timeout=timeout)


def test_policy_registry_same_names_and_order():
    assert t_policy.available_policies() == r_policy.available_policies()
    assert list(t_policy._POLICY_REGISTRY) == list(r_policy._POLICY_REGISTRY)
    assert set(POLICIES) <= set(t_policy.available_policies())


@pytest.mark.parametrize("fork", [True, False], ids=["forked", "no-fork"])
def test_sweep_cells_equal_reference(fork):
    kw = dict(policies=POLICIES, gpus_list=GPUS, seeds=(0,), horizon_days=4.0,
              min_hours=4.0, procs=0, fork=fork)
    got = t_sweep.sweep(**kw).to_json()
    want = r_sweep.sweep(**kw).to_json()
    assert len(got["cells"]) == len(POLICIES) * len(GPUS)
    assert same(timeless(got), timeless(want))
    if not fork:
        return
    cold = t_sweep.sweep(**{**kw, "fork": False}).to_json()
    for c in got["cells"] + cold["cells"]:
        c["extra"].pop("fork", None)
    assert same(timeless(got), timeless(cold))


def test_sweep_cli_json_equals_reference(tmp_path):
    args = ["--policies", ",".join(POLICIES), "--gpus", ",".join(map(str, GPUS)),
            "--seeds", "1", "--days", "3", "--min-hours", "4", "--procs", "0",
            "--analytic-bands", "--stat-backend", "numpy"]
    r = cli("repro", args + ["--json", str(tmp_path / "r.json")])
    t = cli("repro_torch", args + ["--json", str(tmp_path / "t.json"),
                                   "--bands-json", str(tmp_path / "b.json")])
    assert r.returncode == 0 and t.returncode == 0, r.stderr + t.stderr
    want = json.loads((tmp_path / "r.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert same(timeless(got), timeless(want))
    bands = json.loads((tmp_path / "b.json").read_text())
    assert bands["backend"] == "numpy" and bands["stat_grid_launches"] == 0
    assert np.asarray(bands["ettr"]).shape == (len(POLICIES), len(GPUS), 1)


def test_analytic_policy_bands_against_reference():
    kw = dict(policies=POLICIES, gpus_list=(512, 2048, 8192), seeds=range(3), r_f=6.5e-3)
    want = r_sweep.analytic_policy_bands(**kw, backend="numpy")
    got_np = t_sweep.analytic_policy_bands(**kw, backend="numpy")
    got = t_sweep.analytic_policy_bands(**kw, backend="torch", device="cpu")
    assert got.backend is tbk.StatBackend.TORCH and got.n_compiled_calls == 1
    for k in CLOSED_FORM:
        w = getattr(want, k)
        assert np.array_equal(getattr(got_np, k), w), k
        np.testing.assert_allclose(getattr(got, k), w, rtol=5e-4, atol=0, err_msg=k)
    # the what-if table itself: one row per (policy, scale)
    assert got.table().count("\n") == 1 + len(POLICIES) * 3


def test_cli_backend_defaults_to_torch_on_the_card(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_STAT_BACKEND", raising=False)
    assert tbk.cli_backend(None, "cpu") is tbk.StatBackend.TORCH
    assert tbk.cli_backend("numpy", "cuda") is tbk.StatBackend.NUMPY
    monkeypatch.setenv("REPRO_TORCH_STAT_BACKEND", "numpy")
    assert tbk.cli_backend(None, "cuda") is tbk.StatBackend.NUMPY
    monkeypatch.setenv("REPRO_TORCH_STAT_BACKEND", "jax_vmap")
    with pytest.raises(ValueError, match="jax_vmap"):
        tbk.cli_backend(None, "cpu")
    with pytest.raises(SystemExit):
        t_sweep.main(["--analytic-bands", "--stat-backend", "jax_vmap"])


def test_sweep_cli_never_hides_the_card(tmp_path):
    args = ["--policies", "baseline", "--gpus", "256", "--seeds", "1", "--days", "1",
            "--procs", "0", "--analytic-bands"]
    r = cli("repro_torch", args, env_extra=NO_CUDA)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "cells in" not in r.stdout          # it stopped before the replays
    r = cli("repro_torch", args + ["--device", "cpu"], env_extra=NO_CUDA)
    assert r.returncode == 0, r.stderr
    assert "TORCH" in r.stdout and "1 cells in" in r.stdout


@pytest.mark.parametrize("mode", ["progress", "heartbeat", "cache"])
def test_sweep_obs_flags_equal_reference(tmp_path, mode):
    """--progress / --heartbeat on the port's sweep give the reference's
    beats: cell labels, done / total and phases (one probe-carrying
    "prefix" cell a (scale, seed) group and "suffix" cells under the fork
    plan; "cached" from a warm cell cache). Only the walls differ."""
    args = ["--policies", "baseline,lemon_eviction,checkpoint_optimal", "--gpus", "256,512",
            "--seeds", "1", "--days", "2", "--min-hours", "4"]
    got = obs_flag_runs(cli, tmp_path, args, mode)["repro_torch"]
    assert len(got) == 6
    if mode == "progress":
        assert [g[3] for g in got] == ["[prefix]", "[suffix]", "[suffix]"] * 2
