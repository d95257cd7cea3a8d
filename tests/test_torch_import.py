"""repro_torch stands alone: it imports neither jax nor anything of repro,
and its entry points run on the card unless the caller asks for the CPU."""
import json
import os
import pathlib
import subprocess
import sys

from tests.conftest import run_subprocess_py

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
NO_CUDA = {"CUDA_VISIBLE_DEVICES": ""}


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.kernels.flash_attention" in mods and len(mods) >= 14
    for mod in ("hw", "roofline", "specs", "trace_analysis", "dryrun"):
        assert f"repro_torch.launch.{mod}" in mods
    assert "repro_torch.kernels.cost" in mods
    for mod in ("obs", "obs.metrics", "obs.emit", "obs.profiler", "obs.report",
                "fabric.topology", "fabric.routing", "fabric.simulate"):
        assert f"repro_torch.{mod}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    r = run_subprocess_py(code, env_extra=NO_CUDA)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_obs_and_fabric_leave_torch_unloaded():
    """The telemetry and the fabric model are host code: importing them
    (and the report CLI) loads neither torch nor jax nor the reference."""
    code = (
        "import json, sys\n"
        "import repro_torch.obs, repro_torch.obs.report\n"
        "import repro_torch.fabric.simulate\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                        in ('torch', 'jax', 'repro'))))\n")
    r = run_subprocess_py(code, env_extra=NO_CUDA)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_neither_jax_nor_repro():
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "repro"), line


def test_server_without_device_refuses_to_run_on_cpu():
    code = (
        "from repro_torch.configs.base import get_arch, smoke_config\n"
        "from repro_torch.runtime.serve_loop import ServeConfig, Server\n"
        "try:\n"
        "    Server(smoke_config(get_arch('rsc-llm')), ServeConfig())\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "else:\n"
        "    print('ran')\n")
    r = run_subprocess_py(code, env_extra=NO_CUDA)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "raised: no CUDA device" in r.stdout


def test_launcher_defaults_to_cuda_and_runs_on_cpu_when_asked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **NO_CUDA)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
           "--batch", "2", "--prompt-len", "8", "--new-tokens", "3"]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    r = subprocess.run(cmd + ["--device", "cpu", "--inject-rate", "0.3"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout)
    assert rep["arch"] == "qwen3-0.6b-smoke" and rep["tokens"] == 6 and rep["retries"] >= 0


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory, the script fails and prints
    no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                           timeout=120, env=dict(os.environ, **NO_CUDA), cwd=script.parent)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
