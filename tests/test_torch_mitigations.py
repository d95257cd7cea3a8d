"""The port's mitigation lab (``repro_torch.mitigations``) against the JAX
package's on the CPU: the policy registry, the sweep's per-cell rows
(forked and cold), the CLI's ``--json``, and the batched what-if table,
whose numpy tier equals the reference's to the bit and whose torch tier
(``stat_grid``'s plain version with ``device="cpu"``) is within 5e-4.
Without a card, ``--analytic-bands`` stops with "no CUDA device".
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.mitigations import policy as r_policy
from repro.mitigations import sweep as r_sweep
from repro_torch.core import backend as tbk
from repro_torch.mitigations import policy as t_policy
from repro_torch.mitigations import sweep as t_sweep

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


@pytest.mark.parametrize("flag", [["--progress"], ["--heartbeat", "hb.jsonl"]])
def test_sweep_obs_flags_are_not_ported(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_sweep.main(["--gpus", "256", "--seeds", "1", "--days", "0.1", *flag])
