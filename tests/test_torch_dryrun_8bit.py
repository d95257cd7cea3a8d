"""The dry run under the 8-bit AdamW state (``REPRO_OPT8BIT=1``) at smoke
size: the training cells that ``tests/test_torch_dryrun.py`` traces (smoke
qwen3-0.6b and smoke mixtral-8x22b on a fake 2 x 2 x 2 ("pod", "data",
"model") mesh of fake CPU tensors), in a subprocess of its own (the fake
process group is the process's default group).

Smoke widths are powers of two of at most 256, so a leaf whose last axis
is split over the 2-way ``data`` or ``model`` dim keeps half a block a
rank: the embedding's (vocab, embed) last axis among them, as in the
full-width cells whose blocks span ranks (qwen3-0.6b's embedding, its
1024 split 16 ways).  Each cell traces, its update takes the path that
all-reduces the blocks' maxima for those leaves and the local one for the
others, and the optimizer moments a rank holds, in bytes, are about the
8-bit state's share of the f32 state's: two int8 codes and two f32
scales a block for a quantized leaf, two f32 for the others (2 + 8 /
block of 8 bytes a quantized element; 2.03 at full width's blocks of
256).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import json, math, os, torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs.base import ShapeSpec, get_arch, smoke_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import params as pmod
    from repro_torch.optim import adamw

    torch.set_num_threads(1)
    dryrun.fake_world(8)
    mesh = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
    train = ShapeSpec("train_4k", "train", 64, 8)
    out = {}

    def moment_bytes(cfg, rules):
        # the moments a rank holds, placed as the dry run places them
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = dryrun._place(specs.input_specs(cfg, train, "cpu"),
                                 specs.input_shardings(cfg, train, mesh, rules), mesh)
            opt = args[1]
            return sum(t.numel() * t.element_size() for t in dryrun._local([opt.m, opt.v]))

    def expected_share(cfg):
        # the 8-bit state's bytes over the f32 state's, from the shapes
        q8 = f32 = 0
        for _, d in pmod.flatten(specs.train_defs(cfg)):
            n = math.prod(d.shape)
            f32 += 8 * n
            quant = len(d.shape) >= 1 and n >= adamw.QUANT_MIN_SIZE
            q8 += 2 * n + 8 * n // adamw._opt_block(d.shape[-1]) if quant else 8 * n
        return q8 / f32

    for arch in ("qwen3-0.6b", "mixtral-8x22b"):
        cfg = smoke_config(get_arch(arch))
        rules = specs.rules_for(train)
        os.environ["REPRO_OPT8BIT"] = "0"
        f32_bytes = moment_bytes(cfg, rules)
        os.environ["REPRO_OPT8BIT"] = "1"
        q8_bytes = moment_bytes(cfg, rules)
        adamw.sharded_updates.update(local=0, spanning=0)
        t = dryrun.trace(cfg, train, mesh, rules, specs.input_shardings(cfg, train, mesh, rules),
                         device="cpu", pod_size=4)
        out[arch] = {"peak": t["peak"], "flops": t["flops"],
                     "kernel_calls": t["kernel_calls"], "paths": dict(adamw.sharded_updates),
                     "f32_moment_bytes": f32_bytes, "q8_moment_bytes": q8_bytes,
                     "expected_share": expected_share(cfg)}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def traced():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", SCRIPT], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b"])
def test_8bit_train_cell_traces(traced, arch):
    t = traced[arch]
    assert t["peak"] > 0 and t["flops"] > 0
    assert t["kernel_calls"]["flash_attention_bwd"] > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b"])
def test_8bit_cell_takes_both_update_paths(traced, arch):
    """Some leaves' blocks span ranks (the all-reduced path), the others
    are whole on every rank (the local path)."""
    paths = traced[arch]["paths"]
    assert paths["spanning"] > 0 and paths["local"] > 0, paths


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b"])
def test_8bit_moments_a_rank_are_the_8bit_share(traced, arch):
    """The moments a rank holds under the 8-bit state, over the f32
    state's: at least the share the global shapes give and at most 10%
    above it (a leaf whose blocks span ranks keeps its scales replicated
    over the dims that split them, and leaves under QUANT_MIN_SIZE stay
    f32), about a quarter."""
    t = traced[arch]
    share = t["q8_moment_bytes"] / t["f32_moment_bytes"]
    assert t["expected_share"] <= share <= 1.1 * t["expected_share"], share
    assert 2 / 8 < share < 2.4 / 8
