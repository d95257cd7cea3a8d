"""The dry run at smoke size: the port's counterpart of
tests/test_system.py's ``test_small_mesh_dryrun_subprocess``.

In a subprocess of its own (the fake process group is the process's
default group), smoke qwen3-0.6b (qk-norm, tied embeddings) and smoke
mixtral-8x22b (MoE) are traced on a fake 2 x 2 x 2 ("pod", "data",
"model") mesh of fake CPU tensors: a training step (with the ``dots``
remat policy too, set as the dry run's ``--set`` sets it) and a decode
step.  Each counts FLOPs and bytes, the training steps collectives and the
kernels' fake-route work.  A sharded matmul's count on a mesh of 4 is a
quarter of the count on a mesh of 1 (the counts are per rank).  The
collective accounting is held to ``hlo_analysis``'s on the same (kind,
size, group) triples, and the CLI writes the reference's record keys.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.launch import hlo_analysis
from repro_torch.launch import trace_analysis

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import json, torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import ShapeSpec, get_arch, smoke_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.trace_analysis import TraceCounter

    torch.set_num_threads(1)
    dryrun.fake_world(8)
    mesh = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
    out = {}
    train = ShapeSpec("train_4k", "train", 64, 8)
    decode = ShapeSpec("decode_32k", "decode", 128, 8)
    for arch, over in (("qwen3-0.6b", {}), ("qwen3-0.6b", {"remat_policy": "dots"}),
                       ("mixtral-8x22b", {})):
        cfg, _, _ = dryrun.parse_overrides(smoke_config(get_arch(arch)), over)
        for shape in ((train,) if over else (train, decode)):
            rules = specs.rules_for(shape)
            t = dryrun.trace(cfg, shape, mesh, rules, specs.input_shardings(cfg, shape, mesh, rules),
                             device="cpu", pod_size=4)
            out["/".join([arch, shape.kind] + list(over.values()))] = {
                k: t[k] for k in ("flops", "bytes", "kernel_flops", "kernel_calls", "peak",
                                  "collectives")}

    # per rank: x @ w with w's columns sharded over n ranks
    def mm_flops(n):
        m = DeviceMesh("cpu", torch.arange(n))
        with FakeTensorMode():
            x, w = torch.empty(8, 64), torch.empty(64, 128)
            xd = distribute_tensor(x, m, [Replicate()], src_data_rank=None)
            wd = distribute_tensor(w, m, [Shard(1)], src_data_rank=None)
            with TraceCounter() as c:
                xd @ wd
        return c.flops
    out["mm"] = [mm_flops(1), mm_flops(4)]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def traced():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", SCRIPT], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["qwen3-0.6b/train", "qwen3-0.6b/decode",
                                  "qwen3-0.6b/train/dots", "mixtral-8x22b/train",
                                  "mixtral-8x22b/decode"])
def test_small_mesh_cells_count_work(traced, cell):
    t = traced[cell]
    assert t["flops"] > 0 and t["bytes"] > 0 and t["peak"] > 0
    if "train" in cell:
        assert t["collectives"]["total_bytes"] > 0
        # attention's forward (with the LSE) and backward on the fake route
        assert t["kernel_flops"] > 0 and t["kernel_calls"]["flash_attention_bwd"] > 0
    coll = t["collectives"]
    assert coll["total_bytes"] == pytest.approx(coll["intra_pod_bytes"] + coll["cross_pod_bytes"])


def test_dots_keeps_the_work_and_the_count(traced):
    """The dots policy recomputes less: the same step counts fewer or as
    many FLOPs as under full."""
    assert 0 < traced["qwen3-0.6b/train/dots"]["flops"] <= traced["qwen3-0.6b/train"]["flops"]


def test_counts_are_per_rank(traced):
    one, four = traced["mm"]
    assert one == 2 * 8 * 64 * 128 and four == one / 4


def _hlo(kind: str, size: int, groups: str) -> str:
    n = size // 4
    shape_in = {"all-gather": n // 4, "reduce-scatter": n * 4}.get(kind, n)
    attrs = {"all-reduce": "to_apply=%add", "reduce-scatter": "to_apply=%add, dimensions={0}",
             "all-gather": "dimensions={0}", "all-to-all": "dimensions={0}",
             "collective-permute": "source_target_pairs={{0,1},{1,0}}"}[kind]
    groups_attr = "" if kind == "collective-permute" else f"replica_groups={groups}, "
    return textwrap.dedent(f"""
        HloModule m

        %add (a: f32[], b: f32[]) -> f32[] {{
          %a = f32[] parameter(0)
          %b = f32[] parameter(1)
          ROOT %s = f32[] add(%a, %b)
        }}

        ENTRY %main (p: f32[{shape_in}]) -> f32[{n}] {{
          %p = f32[{shape_in}] parameter(0)
          ROOT %c = f32[{n}] {kind}(%p), {groups_attr}{attrs}
        }}
    """)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("ranks", [[0, 1, 2, 3], [0, 8], list(range(16))])
def test_collective_bytes_match_hlo_analysis(kind, ranks):
    size = 4096 * 4
    groups = "{{" + ",".join(map(str, ranks)) + "}}"
    want = hlo_analysis.analyze_module(_hlo(kind, size, groups), pod_size=8)["collectives"]
    counter = trace_analysis.TraceCounter(pod_size=8)
    counter.collective(kind, size, ranks)
    got = counter.summary()["collectives"]
    assert got["per_op"][kind]["bytes_moved"] == pytest.approx(want["per_op"][kind]["bytes_moved"])
    crosses = len({r // 8 for r in ranks}) > 1
    if kind == "collective-permute":  # the reference reads no group off a permute
        want = {"intra_pod_bytes": 0.0, "cross_pod_bytes": 0.0,
                ("cross_pod_bytes" if crosses else "intra_pod_bytes"): want["total_bytes"]}
    assert got["intra_pod_bytes"] == pytest.approx(want["intra_pod_bytes"])
    assert got["cross_pod_bytes"] == pytest.approx(want["cross_pod_bytes"])
    assert (got["cross_pod_bytes"] > 0) == crosses


def test_cli_writes_the_reference_record(tmp_path):
    """A skipped cell and a traced one through the CLI, in a process of their
    own: the reference's record keys, ``trace_s`` for its compile times."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = tmp_path / "dry"
    for shape in ("long_500k", "decode_32k"):
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                            "qwen3-0.6b", "--shape", shape, "--mesh", "single", "--device",
                            "cpu", "--out", str(out)], env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-4000:]
    skipped = json.loads((out / "qwen3-0.6b__long_500k__single.json").read_text())
    assert skipped["status"] == "skipped_full_attention"
    rec = json.loads((out / "qwen3-0.6b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    for key in ("memory", "cost", "collectives", "roofline", "fit_attempts", "n_microbatches",
                "fits_hbm", "params_total", "params_active", "sharding_fallbacks", "trace_s"):
        assert key in rec, key
    assert rec["memory"]["peak_device_bytes"] > rec["memory"]["argument_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["collectives"]["pod_size"] == 8
