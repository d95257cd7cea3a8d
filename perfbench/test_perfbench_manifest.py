"""The benchmark's manifest (``BENCHMARK.json``) against the files it names
and the rules it is written to; the imports of the benchmark's modules."""
import ast
import importlib.util
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _metric(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys_and_sizes(bench):
    assert list(bench) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert bench["paths"] == ["perfbench"]
    assert 1 <= len(bench["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_text_fields(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[section]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs_resolve(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert set(cfg["published"]) == set(c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads_resolve_by_name(bench):
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        # the cell's own file holds its limits and nothing the manifest says
        own = json.loads((HERE / "workloads" / f"{w['name']}.json").read_text())
        assert set(own) == {"limits"}
        cfg = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
        numbers = {"loss_gap", "grad_gap", "update_gap", "grad_err", "update_err"} | (
            {"route_gap"} if cfg["moe"] else set())
        assert set(own["limits"]) == numbers
        traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert traffic["batch"] % traffic["n_microbatches"] == 0
        assert traffic["pool_batches"] > traffic["check_steps"] >= 2


def test_end_to_end_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_each_metric_file_declares_its_layer_unit_and_moves(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        mod = _metric(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == \
            (m["layer"], m["unit"], m["better"], m["source"], m["moves"])
        assert callable(mod.read) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    assert sorted(p.stem for p in (HERE / "metrics").glob("*.py")) == \
        sorted(m["name"] for m in bench["per_layer"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(bench):
    from perfbench import harness

    for w in bench["workloads"]:
        e2e = [m["name"] for m in harness.metrics_of(bench, "end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(bench, "per_layer", w["name"])


def _imports(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(p.relative_to(HERE).as_posix()
                                        for p in HERE.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = _imports(HERE / path)
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if path.startswith("reference/"):
        assert "repro_torch" not in tops


def test_the_whole_name_check_tells_the_port_from_the_jax_package():
    from perfbench import harness

    assert harness.loaded_forbidden(["repro_torch", "repro_torch.models", "numpy"]) == []
    assert harness.loaded_forbidden(["repro.models.steps", "jaxlib.xla", "torch"]) == \
        ["jaxlib", "repro"]


def test_each_configuration_is_the_ports_registered_one_but_its_reduced_keys():
    import dataclasses

    from perfbench import harness
    from repro_torch.configs.base import get_arch

    for path in sorted((HERE / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        mine = dataclasses.asdict(harness.arch_config(cfg))
        port = dataclasses.asdict(get_arch(cfg["name"].split(".")[0]))
        skip = {"name", "notes", "source", "long_context_ok", "block_groups"} | set(cfg["reduced"])
        assert {k: v for k, v in mine.items() if k not in skip} == \
            {k: v for k, v in port.items() if k not in skip}, path.name
        assert port["n_layers"] == cfg["published"]["n_layers"]
        assert port["block_groups"] == (((cfg["layer_kind"],), port["n_layers"]),)
