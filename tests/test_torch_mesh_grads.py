"""Gradients of the whole model on a 2 x 2 ("data", "model") mesh against
``jax.grad`` of the JAX package's loss on the same weights and batch.

The train step's AdamW update near its start is about lr * sign(g), so a
stepped weight cannot show a gradient summed too often or too rarely over
a mesh dim: the gradients themselves are compared here, leaf by leaf.
A per-rank partial sum labelled ``Replicate`` (or a replicated gradient
labelled ``Partial``) is off by a factor of the mesh dim's size, 2, which
the relative bound below catches on every leaf.

Cases, each through ``steps.loss_and_grads`` on DTensor params placed by
``reshard_for`` under TRAIN_RULES, with the batch sharded over ``data``:

* smoke rsc-llm: head-sharded attention (8 heads, 2 kv heads, both over
  ``model``), the embedding lookup through ``local_map`` (the table's
  gradient Partial over ``data``);
* smoke rsc-llm with 3 heads and 1 kv head: context-parallel attention
  (3 % 2 != 0), dK / dV Partial over ``model``;
* smoke rwkv6-7b: WKV-6 through ``local_map`` (u's gradient Partial over
  ``data``), the constraints around the low-rank reshape and unbind;
* smoke recurrentgemma-9b: RG-LRU through ``local_map`` (channels over
  ``model``), and MQA local attention whose one kv head is sliced on every
  model rank (its gradient Partial over ``model``);
* smoke mixtral-8x22b: MoE routed on each data rank's own group of 64
  tokens (``layers.routes``), the router's gradient Partial over
  ``data``, the aux losses averaged over the data ranks, the experts'
  matmuls on their ``model`` shards.

The JAX gradients are taken unsharded (a gradient does not depend on the
layout).  The same run also calls WKV-6 and RG-LRU on the mesh with a
given state, which each rank copies and the op writes back, against the
unsharded calls.  Everything runs in one 4-rank gloo run and one JAX
subprocess (tests/test_torch_parallel.py's ``run_ranks`` / ``run_jax``).
"""
import numpy as np
import pytest
import torch

from tests.test_torch_parallel import run_jax, run_ranks

B, S = 4, 32
CASES = {
    "rsc-llm": ("rsc-llm", {}),
    "rsc-llm-cp": ("rsc-llm", {"n_heads": 3, "n_kv_heads": 1}),
    "rwkv6-7b": ("rwkv6-7b", {}),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}),
    "mixtral-8x22b": ("mixtral-8x22b", {}),
}
# max |g - g_jax| over a leaf, relative to max |g_jax| (f32 sums in other
# orders, over two layers or more); a factor-2 fault is 0.5 or more
REL = 1e-4
# a leaf whose reference gradient is this small is held absolutely
TINY = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_grads")
    run_jax(f"""
        os.environ["REPRO_COMPUTE_DTYPE"] = "float32"  # read when repro is imported
        import jax, jax.numpy as jnp, numpy as np
        from repro.checkpoint.manager import _flatten
        from repro.configs.base import get_arch, smoke_config
        from repro.models import params as pmod, transformer
        res = {{}}
        for name, (arch, over) in {CASES!r}.items():
            cfg = smoke_config(get_arch(arch)).replace(**over)
            params = pmod.materialize(transformer.model_defs(cfg), seed=7)
            tokens = np.random.default_rng(13).integers(
                3, cfg.vocab_size, ({B}, {S} + 1)).astype(np.int32)
            (loss, _), grads = jax.value_and_grad(transformer.loss_fn, has_aux=True)(
                params, cfg, {{"tokens": jnp.asarray(tokens)}})
            res[name + "/tokens"] = tokens
            res[name + "/loss"] = np.asarray(loss)
            for tag, tree in (("params", params), ("grads", grads)):
                for k, v in _flatten(tree).items():
                    res[f"{{name}}/{{tag}}/{{k}}"] = np.asarray(v)
        np.savez({str(out / 'jax.npz')!r}, **res)
        print("OK")
    """, 1)
    run_ranks(f"""
        from torch.distributed.tensor import DTensor, distribute_tensor
        from repro_torch.configs.base import get_arch, smoke_config
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import layers, transformer
        from repro_torch.models.convert import from_jax_params
        from repro_torch.models.steps import loss_and_grads
        from repro_torch.parallel.axes import TRAIN_RULES, mesh_context, placements_for
        from repro_torch.runtime.elastic import reshard_for
        d = np.load(os.path.join(OUT, "jax.npz"))
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        res = {{}}
        for name, (arch, over) in {CASES!r}.items():
            cfg = smoke_config(get_arch(arch)).replace(**over)
            pre = name + "/params/"
            params = from_jax_params({{k[len(pre):]: d[k] for k in d.files if k.startswith(pre)}})
            tokens = torch.from_numpy(d[name + "/tokens"]).long()
            with mesh_context(mesh, TRAIN_RULES):
                dp = reshard_for(params, mesh, TRAIN_RULES, transformer.model_defs(cfg))
                batch = {{"tokens": distribute_tensor(
                    tokens, mesh, placements_for(tokens.shape, ("act_batch", None)),
                    src_data_rank=None)}}
                before = dict(layers.routes)
                loss, _, grads = loss_and_grads(cfg, dp, batch, dtype=torch.float32)
                res[name + "/routes"] = np.array(
                    [layers.routes[k] - before[k] for k in ("per_rank", "whole_batch")])
                # each gradient as the optimizer meets it: on its param's placements
                for k, g in grads.items():
                    assert isinstance(g, DTensor), k
                    g = g.redistribute(mesh, dp[k].placements)
                    res[f"{{name}}/grads/{{k}}"] = g.full_tensor().numpy()
                res[name + "/loss"] = loss.full_tensor().numpy()
        # WKV-6 and RG-LRU with a nonzero state: each rank's copy of its shard,
        # the final state written back into the given DTensor
        from repro_torch.kernels import ops
        from repro_torch.parallel.axes import distribute_as
        rng = np.random.default_rng(17)
        f32 = lambda *shape: torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32))
        head = ("act_batch", "act_seq", "act_heads", None)
        wkv_in = [f32(4, 8, 2, 16) for _ in range(3)] + [
            torch.from_numpy(rng.uniform(0.45, 0.95, (4, 8, 2, 16)).astype(np.float32)),
            f32(2, 16), f32(4, 2, 16, 16)]
        lru_in = [f32(4, 8, 8), -torch.from_numpy(rng.uniform(0, 0.5, (4, 8, 8)).astype(np.float32)),
                  f32(4, 8)]
        for name, fn, ins, axes in (
                ("wkv6", ops.wkv6, wkv_in, 4 * [head] + [("act_heads", None),
                                                         ("act_batch", "act_heads", None, None)]),
                ("rglru", ops.rglru, lru_in, 2 * [("act_batch", "act_seq", "act_lru")]
                 + [("act_batch", "act_lru")])):
            local = [t.clone() for t in ins]
            out, _ = fn(*local)
            res[f"state/{{name}}/want_out"], res[f"state/{{name}}/want_state"] = (
                out.numpy(), local[-1].numpy())
            with mesh_context(mesh, TRAIN_RULES):
                dins = [distribute_as(t.clone(), *ax) for t, ax in zip(ins, axes)]
                state = dins[-1]
                out, new = fn(*dins)
                res[f"state/{{name}}/out"] = out.full_tensor().numpy()
                res[f"state/{{name}}/state"] = state.full_tensor().numpy()
                res[f"state/{{name}}/returned"] = new.full_tensor().numpy()
            res[f"state/{{name}}/init"] = ins[-1].numpy()
        if RANK == 0:
            np.savez(os.path.join(OUT, "torch.npz"), **res)
        dist.barrier()
        dist.destroy_process_group()
    """, 4, out)
    with np.load(out / "jax.npz") as j, np.load(out / "torch.npz") as t:
        return {k: j[k] for k in j.files}, {k: t[k] for k in t.files}


@pytest.mark.parametrize("name", CASES)
def test_mesh_grads_match_jax(runs, name):
    want, got = runs
    assert abs(float(got[name + "/loss"]) - float(want[name + "/loss"])) < 1e-5
    per_rank, whole_batch = got[name + "/routes"]
    # MoE: every call (the forward's and the remat recompute's) routes per rank
    assert whole_batch == 0 and (per_rank > 0) == (name == "mixtral-8x22b")
    pre = name + "/grads/"
    w = {k[len(pre):]: want[k] for k in want if k.startswith(pre)}
    g = {k[len(pre):]: got[k] for k in got if k.startswith(pre)}
    assert set(g) == set(w)
    for k, ref in w.items():
        assert g[k].shape == ref.shape, k
        scale = float(np.abs(ref).max())
        err = float(np.abs(g[k] - ref).max())
        assert err <= max(REL * scale, TINY), f"{k}: max err {err:.3g}, max |g| {scale:.3g}"


@pytest.mark.parametrize("name", ["wkv6", "rglru"])
def test_mesh_state_is_written_back(runs, name):
    """A state given on the mesh is updated in place with each rank's final
    state, as the local call updates its own: output and state equal to the
    unsharded call's (the same kernel on a slice of the rows and heads)."""
    _, got = runs
    pre = f"state/{name}/"
    np.testing.assert_allclose(got[pre + "out"], got[pre + "want_out"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[pre + "state"], got[pre + "want_state"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[pre + "returned"], got[pre + "state"])
    assert np.abs(got[pre + "want_state"] - got[pre + "init"]).max() > 0.01
