"""Elastic shrink-and-resume on a DeviceMesh, against the JAX package and
against an unsharded run.

* The counterpart of tests/test_parallel.py::test_elastic_resume_subprocess:
  ``plan_shrink(4, model_parallel=2, old_global_batch=8, old_data=4)``, a
  2 x 2 ("data", "model") mesh on 4 gloo ranks, smoke rsc-llm placed by
  ``reshard_for`` under TRAIN_RULES, one f32 train step under
  ``mesh_context``.  Its loss is held to the JAX package's jit step on the
  same weights and batch on a 2 x 2 mesh of forced host devices at
  tests/test_torch_train.py's 1e-5, and its stepped weights to the port's
  unsharded step within 1e-6.
* A real shrink: a 4 x 2 world of 8 ranks takes step 1 and saves through
  the port's ``CheckpointManager``; a new world of the 4 survivors restores,
  plans, reshards and takes step 2 at the shrunk batch.  Losses and weights
  equal a single-process run of the same two steps within 1e-6.

The optimizer is ``AdamWConfig()``, as the reference's elastic test: its
first steps are small (lr warms up from 0), so a weight moves by at most
~lr, and the 1e-6 on the weights is held where AdamW's sign sensitivity
near g = 0 (tests/test_torch_train.py) cannot reach it.  Those steps are
about lr * sign(g), so they cannot show a gradient's scale:
tests/test_torch_mesh_grads.py holds the mesh gradients themselves.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.models import params as pmod
from repro_torch.models import transformer
from repro_torch.models.convert import from_jax_params
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw
from tests.test_torch_parallel import run_jax, run_ranks


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(rows: int, seed: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(3, vocab, (rows, 33)).astype(np.int64)


def test_elastic_step_matches_jax_and_unsharded(tmp_path):
    cfg = smoke_config(get_arch("rsc-llm"))
    tokens = _tokens(4, 5, cfg.vocab_size)  # plan.global_batch rows
    np.save(tmp_path / "tokens.npy", tokens)
    run_jax(f"""
        os.environ["REPRO_COMPUTE_DTYPE"] = "float32"  # read when repro is imported
        import jax, jax.numpy as jnp, numpy as np
        from repro.checkpoint.manager import _flatten
        from repro.configs.base import get_arch, smoke_config
        from repro.models import params as pmod, transformer
        from repro.models.steps import make_train_step
        from repro.optim import adamw
        from repro.parallel.axes import TRAIN_RULES, mesh_context
        from repro.runtime.elastic import make_elastic_mesh, plan_shrink, reshard_for
        cfg = smoke_config(get_arch("rsc-llm"))
        defs = transformer.model_defs(cfg)
        params = pmod.materialize(defs, seed=0)
        plan = plan_shrink(4, model_parallel=2, old_global_batch=8, old_data=4)
        assert (plan.data, plan.model, plan.global_batch) == (2, 2, 4)
        mesh = make_elastic_mesh(plan)
        params2 = reshard_for(params, mesh, TRAIN_RULES, defs)
        step = make_train_step(cfg, adamw.AdamWConfig())
        tokens = np.load({str(tmp_path / 'tokens.npy')!r}).astype(np.int32)
        with mesh_context(mesh, TRAIN_RULES):
            with mesh:
                p, o, m = jax.jit(step)(params2, adamw.init(params2),
                                        {{"tokens": jnp.asarray(tokens)}})
        np.savez({str(tmp_path / 'jax.npz')!r}, loss=np.asarray(m["loss"]),
                 **{{"params/" + k: np.asarray(v) for k, v in _flatten(params).items()}})
        print("OK")
    """, 8)
    run_ranks("""
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs.base import get_arch, smoke_config
        from repro_torch.models import transformer
        from repro_torch.models.convert import from_jax_params
        from repro_torch.models.steps import make_train_step
        from repro_torch.optim import adamw
        from repro_torch.parallel.axes import TRAIN_RULES, mesh_context, placements_for
        from repro_torch.runtime.elastic import (host_tree, make_elastic_mesh, plan_shrink,
                                                 reshard_for)
        cfg = smoke_config(get_arch("rsc-llm"))
        defs = transformer.model_defs(cfg)
        d = np.load(os.path.join(OUT, "jax.npz"))
        params = from_jax_params({k[7:]: d[k] for k in d.files if k.startswith("params/")})
        plan = plan_shrink(4, model_parallel=2, old_global_batch=8, old_data=4)
        mesh = make_elastic_mesh(plan, device_type="cpu")
        tokens = torch.from_numpy(np.load(os.path.join(OUT, "tokens.npy")))
        step = make_train_step(cfg, adamw.AdamWConfig(), dtype=torch.float32)
        with mesh_context(mesh, TRAIN_RULES):
            dp = reshard_for(params, mesh, TRAIN_RULES, defs)
            batch = {"tokens": distribute_tensor(
                tokens, mesh, placements_for(tokens.shape, ("act_batch", None)),
                src_data_rank=None)}
            p, o, m = step(dp, adamw.init(dp), batch)
            stepped = host_tree(p)
            loss = m["loss"].full_tensor()
        if RANK == 0:
            np.savez(os.path.join(OUT, "torch.npz"), loss=loss.numpy(),
                     **{k: t.numpy() for k, t in stepped.items()})
        dist.barrier()
        dist.destroy_process_group()
    """, 4, tmp_path)
    jax_out, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "torch.npz")
    assert abs(float(got["loss"]) - float(jax_out["loss"])) < 1e-5
    params = from_jax_params({k[7:]: jax_out[k] for k in jax_out.files
                              if k.startswith("params/")})
    step = make_train_step(cfg, adamw.AdamWConfig(), dtype=torch.float32)
    want, _, m = step(params, adamw.init(params), {"tokens": torch.from_numpy(tokens)})
    assert abs(float(got["loss"]) - float(m["loss"])) < 1e-6
    assert set(got.files) == set(want) | {"loss"}
    for k, t in want.items():
        np.testing.assert_allclose(got[k], t.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_shrink_from_8_to_4_ranks_and_resume(tmp_path):
    cfg = smoke_config(get_arch("rsc-llm"))
    np.save(tmp_path / "b1.npy", _tokens(8, 1, cfg.vocab_size))
    np.save(tmp_path / "b2.npy", _tokens(4, 2, cfg.vocab_size))
    common = """
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.configs.base import get_arch, smoke_config
        from repro_torch.models import params as pmod, transformer
        from repro_torch.models.steps import make_train_step
        from repro_torch.optim import adamw
        from repro_torch.parallel.axes import TRAIN_RULES, mesh_context, placements_for
        from repro_torch.runtime import elastic
        cfg = smoke_config(get_arch("rsc-llm"))
        defs = transformer.model_defs(cfg)
        step = make_train_step(cfg, adamw.AdamWConfig(), dtype=torch.float32)
        ckpt = CheckpointManager(os.path.join(OUT, "ckpt"))

        def batch(name, mesh):
            t = torch.from_numpy(np.load(os.path.join(OUT, name)))
            return {"tokens": distribute_tensor(
                t, mesh, placements_for(t.shape, ("act_batch", None)), src_data_rank=None)}
    """
    # step 1 on the full 4 x 2 world, then a checkpoint of full tensors
    run_ranks(common + """
        plan = elastic.ShrinkPlan(8, 4, 2, 8)
        mesh = elastic.make_elastic_mesh(plan, device_type="cpu")
        with mesh_context(mesh, TRAIN_RULES):
            params = elastic.reshard_for(pmod.materialize(defs, seed=0), mesh, TRAIN_RULES, defs)
            p, o, m = step(params, adamw.init(params), batch("b1.npy", mesh))
            tree = {"params": elastic.host_tree(p), "m": elastic.host_tree(o.m),
                    "v": elastic.host_tree(o.v), "step": o.step}
            loss = float(m["loss"].full_tensor())
        if RANK == 0:
            ckpt.save(1, tree, extra={"loss": loss})
        dist.barrier()
        dist.destroy_process_group()
    """, 8, tmp_path)
    # the 4 survivors: a new launch that restores, plans, reshards, steps
    run_ranks(common + """
        host = pmod.materialize(defs, seed=0)
        template = {"params": host, "m": host, "v": host,
                    "step": torch.zeros((), dtype=torch.int32)}
        at, tree, extra = ckpt.restore(template)
        assert at == 1
        plan = elastic.plan_shrink(WORLD, model_parallel=2, old_global_batch=8, old_data=4)
        assert (plan.data, plan.model, plan.global_batch) == (2, 2, 4)
        mesh = elastic.make_elastic_mesh(plan, device_type="cpu")
        with mesh_context(mesh, TRAIN_RULES):
            place = lambda t: elastic.reshard_for(t, mesh, TRAIN_RULES, defs)
            state = adamw.AdamWState(tree["step"], place(tree["m"]), place(tree["v"]))
            p, o, m = step(place(tree["params"]), state, batch("b2.npy", mesh))
            out = elastic.host_tree(p)
            loss = float(m["loss"].full_tensor())
        if RANK == 0:
            np.savez(os.path.join(OUT, "resumed.npz"), loss1=extra["loss"], loss2=loss,
                     **{k: t.numpy() for k, t in out.items()})
        dist.barrier()
        dist.destroy_process_group()
    """, 4, tmp_path)
    got = np.load(tmp_path / "resumed.npz")
    step = make_train_step(cfg, adamw.AdamWConfig(), dtype=torch.float32)
    params = pmod.materialize(transformer.model_defs(cfg), seed=0)
    p, o, m1 = step(params, adamw.init(params),
                    {"tokens": torch.from_numpy(np.load(tmp_path / "b1.npy"))})
    p, o, m2 = step(p, o, {"tokens": torch.from_numpy(np.load(tmp_path / "b2.npy"))})
    assert abs(float(got["loss1"]) - float(m1["loss"])) < 1e-6
    assert abs(float(got["loss2"]) - float(m2["loss"])) < 1e-6
    for k, t in p.items():
        np.testing.assert_allclose(got[k], t.numpy(), rtol=0, atol=1e-6, err_msg=k)
