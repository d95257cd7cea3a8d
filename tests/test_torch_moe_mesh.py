"""The MoE layer's routing on a mesh: each rank routes its own groups.

The reference keeps a group inside one batch shard ("groups inherit the
token sharding", ``repro.models.layers.moe_ffn``).  The port's
``layers.moe_ffn`` does the same where each batch shard holds whole groups:
each rank routes, gathers and combines its own tokens, and the aux means
are averaged over the batch shards.  Where a group would straddle a shard,
every rank routes the whole batch.  ``layers.routes`` counts the two.

On a 2 x 2 ("data", "model") gloo mesh, smoke mixtral-8x22b's MoE layer
(4 experts top-2, group size 64), its weights placed by TRAIN_RULES and
gathered over the FSDP dim as the model gathers them:

* at B 4, S 32 (a group of 64 on each data rank) the per-rank route runs;
  its output equals the bits of the whole-batch route, which the same call
  takes where the rules leave the batch unsharded (``act_batch`` None, as
  LONG_CONTEXT_RULES leave it), and is the plain call's
  within 1e-5 of the largest (the down projection's model shards are
  summed in another order); its aux values are the plain call's within
  1e-6 relative and its gradients (x, the router, the experts) within 1e-5
  of the largest;
* at B 2, S 24 (one group of 48 over both data ranks) and at decode (B 4,
  S 1) the whole-batch route runs, with the same checks;

and, on the fake 2 x 2 x 2 mesh of tests/test_torch_dryrun.py, a smoke
mixtral-8x22b prefill traced by ``launch.dryrun`` peaks lower on the
per-rank route than the same prefill whose one group of all its tokens
straddles the batch shards (the same expert buffer, every rank routing
all of it).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests.test_torch_parallel import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
# name -> (B, S, the route it must take)
SHAPES = {"aligned": (4, 32, "per_rank"), "straddling": (2, 24, "whole_batch"),
          "decode": (4, 1, "whole_batch")}
AUX_REL = 1e-6
GRAD_REL = 1e-5

RANKS = textwrap.dedent("""
    import contextlib, json
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers, params as pmod
    from repro_torch.parallel.axes import TRAIN_RULES, distribute_as, gather_fsdp, mesh_context
    cfg = smoke_config(get_arch("mixtral-8x22b"))
    defs = layers.moe_defs(cfg)
    weights = pmod.materialize(defs, seed=3)
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    res = {}

    def run(x, p, rules):
        # (out, aux, grads of x and each weight) for sum(out * r) + the aux
        # losses: x and the weights placed by TRAIN_RULES, the layer called
        # under ``rules`` (None: the plain call)
        on_mesh = rules is not None
        leaves = {"x": x.clone(), **{k: v.clone() for k, v in p.items()}}
        with mesh_context(mesh, TRAIN_RULES) if on_mesh else contextlib.nullcontext():
            if on_mesh:
                axes = {"x": ("act_batch", "act_seq", None), **{k: defs[k].axes for k in p}}
                leaves = {k: distribute_as(v, *axes[k]) for k, v in leaves.items()}
            for v in leaves.values():
                v.requires_grad_()
            ps = gather_fsdp({k: v for k, v in leaves.items() if k != "x"})
            with mesh_context(mesh, rules) if on_mesh else contextlib.nullcontext():
                out, aux = layers.moe_ffn(ps, leaves["x"], cfg)
        whole = lambda t: t.full_tensor() if on_mesh else t
        out, aux = whole(out), {k: whole(v) for k, v in aux.items()}
        r = torch.from_numpy(np.random.default_rng(5).normal(size=out.shape).astype(np.float32))
        ((out * r).sum() + aux["moe_lb_loss"] + aux["moe_z_loss"]).backward()
        grads = {k: whole(v.grad) for k, v in leaves.items()}
        return out.detach(), {k: float(v) for k, v in aux.items()}, grads

    for name, (B, S, _) in SHAPES.items():
        x = torch.from_numpy(np.random.default_rng(B * 100 + S).normal(
            0, 1, (B, S, cfg.d_model)).astype(np.float32))
        got = {"plain": run(x, weights, None)}
        for route, rules in (("per_rank", TRAIN_RULES),
                             ("whole_batch", TRAIN_RULES.with_overrides(act_batch=None))):
            before = dict(layers.routes)
            got[route] = run(x, weights, rules)
            res[f"{name}/{route}/routes"] = {k: layers.routes[k] - before[k] for k in before}
        for route, (out, aux, grads) in got.items():
            np.save(os.path.join(OUT, f"{name}_{route}_out.npy"), out.numpy())
            res[f"{name}/{route}/aux"] = aux
            for k, g in grads.items():
                np.save(os.path.join(OUT, f"{name}_{route}_grad_{k}.npy"), g.numpy())
    if RANK == 0:
        with open(os.path.join(OUT, "res.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
""")

DRYRUN = textwrap.dedent("""
    import dataclasses, json, torch
    from repro_torch.configs.base import ShapeSpec, get_arch, smoke_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers

    torch.set_num_threads(1)
    dryrun.fake_world(8)
    mesh = make_test_mesh(data=2, model=2, pod=2, device_type="cpu")
    cfg = smoke_config(get_arch("mixtral-8x22b"))
    shape = ShapeSpec("prefill_32k", "prefill", 512, 8)
    rules = specs.rules_for(shape)
    # one group of all B * S tokens straddles the 4 batch shards: the same
    # expert buffer (E * groups * C rows) on the whole-batch route
    one_group = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, group_size=shape.global_batch * shape.seq_len))
    out = {}
    for route, c in (("per_rank", cfg), ("whole_batch", one_group)):
        before = dict(layers.routes)
        t = dryrun.trace(c, shape, mesh, rules, specs.input_shardings(c, shape, mesh, rules),
                         device="cpu", pod_size=4)
        out[route] = {
            "peak": t["peak"], "flops": t["flops"],
            "routes": {k: layers.routes[k] - before[k] for k in before}}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_mesh")
    run_ranks(f"SHAPES = {SHAPES!r}\n" + RANKS, 4, out)
    return out, json.loads((out / "res.json").read_text())


def _load(out, name, route, what):
    return np.load(out / f"{name}_{route}_{what}.npy")


@pytest.mark.parametrize("name", SHAPES)
def test_each_shape_takes_its_route(ranks, name):
    _, res = ranks
    n_layers = 1
    want = SHAPES[name][2]
    assert res[f"{name}/per_rank/routes"] == {want: n_layers,
                                              ("whole_batch" if want == "per_rank"
                                               else "per_rank"): 0}
    assert res[f"{name}/whole_batch/routes"] == {"per_rank": 0, "whole_batch": n_layers}


@pytest.mark.parametrize("name", SHAPES)
def test_routes_give_the_same_output(ranks, name):
    """The per-rank route gives the whole-batch route's bits (the same
    groups in the same order, the same gathers and matmul rows, the down
    projection's model shards summed alike); both are the plain call's
    output up to the order of that sum."""
    out, _ = ranks
    plain = _load(out, name, "plain", "out")
    per_rank, whole = (_load(out, name, route, "out") for route in ("per_rank", "whole_batch"))
    np.testing.assert_array_equal(per_rank, whole)
    assert float(np.abs(per_rank - plain).max()) <= GRAD_REL * float(np.abs(plain).max())


@pytest.mark.parametrize("name", SHAPES)
def test_aux_means_over_the_batch_shards(ranks, name):
    """The aux values are means over all groups and tokens: the per-rank
    means averaged over the two data ranks, not one rank's."""
    _, res = ranks
    want = res[f"{name}/plain/aux"]
    for route in ("per_rank", "whole_batch"):
        got = res[f"{name}/{route}/aux"]
        for k, v in want.items():
            assert abs(got[k] - v) <= AUX_REL * max(abs(v), 1e-30) + 1e-12, (route, k, got[k], v)


@pytest.mark.parametrize("name", SHAPES)
def test_routes_give_the_same_gradients(ranks, name):
    """The router's gradient from each rank's own tokens is a partial sum
    over the data ranks (summed, not taken as replicated: that would be off
    by 2); x's and the experts' as the plain call's."""
    out, _ = ranks
    for k in ("x", "router", "w_gate", "w_up", "w_down"):
        want = _load(out, name, "plain", f"grad_{k}")
        scale = float(np.abs(want).max())
        assert scale > 0, k
        for route in ("per_rank", "whole_batch"):
            err = float(np.abs(_load(out, name, route, f"grad_{k}") - want).max())
            assert err <= GRAD_REL * scale, (route, k, err, scale)


def test_dryrun_prefill_peaks_lower_per_rank():
    """A smoke mixtral-8x22b prefill (B 8, S 512: 1024 tokens, 16 groups,
    on each of the 4 batch shards) on the fake 2 x 2 x 2 mesh: the expert
    buffer and the routing tensors hold a rank's own groups, a quarter of
    the batch's, so the traced peak is below that of the same prefill with
    one group of 4096 tokens, whose buffer has as many rows and which every
    rank routes whole; the work traced is lower too."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", DRYRUN], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    per, whole = got["per_rank"], got["whole_batch"]
    assert per["routes"] == {"per_rank": 2, "whole_batch": 0}
    assert whole["routes"] == {"per_rank": 0, "whole_batch": 2}
    assert 0 < per["peak"] < whole["peak"]
    assert 0 < per["flops"] < whole["flops"]
