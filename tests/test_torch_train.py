"""The training slice as a whole: repro_torch's loss, gradients and train
step against the JAX package on the same weights and batches.

A subprocess with REPRO_COMPUTE_DTYPE=float32 (read when repro is imported)
materializes f32 JAX params, takes ``jax.value_and_grad(transformer.loss_fn)``
and one ``make_train_step`` step on a numpy batch, and saves weights, loss,
metrics, gradients and the stepped weights to an npz.  The port loads the
same weights and runs in f32 on the CPU, through the same ``FlashAttention``
Function the card trains through (its plain versions here).

Cases: smoke rsc-llm as configured (remat "full", one loss chunk); with
``loss_chunk`` 8 (four recomputed chunks) and a loss mask; smoke qwen3-0.6b
(qk_norm, tied embeddings); smoke rsc-llm with local layers (window 16);
smoke rwkv6-7b, whose layers train through the ``WKV6`` Function (the
reference differentiates its ``lax.scan`` oracle); and smoke
recurrentgemma-9b, whose RG-LRU layers train through the ``RGLRU`` Function
(the reference differentiates its associative scan) and whose local layers
(MQA) through ``FlashAttention``, as configured (window 64 > S) and with
window 16 < S; smoke gemma3-4b (local and global layers, qk_norm, tied
embeddings, d_head 16 for its 256); smoke mixtral-8x22b (local layers and
the MoE FFN, top-2, whose aux losses enter the loss and the metrics) and
smoke llama4-scout-17b-a16e (chunked layers with a chunk of 16 < S, the MoE
FFN top-1 with a shared expert); smoke starcoder2-3b (GQA, the non-gated
FFN) and smoke granite-20b (MQA, the non-gated FFN).  The first two,
rwkv6-7b, recurrentgemma-9b, gemma3-4b, mixtral-8x22b, qwen3-0.6b and
granite-20b are also stepped with
``n_microbatches=2`` (tests/test_smoke_archs.py's microbatch check), and the
reference's accumulated gradients are saved beside the step.
Tolerances: 1e-5 on the loss and the metrics, 1e-4 on every gradient (two
layers of f32 matmuls and their backward summed in different orders by two
frameworks).  After one AdamW step a weight moves by lr (g / (|g| + eps) +
wd p): a gradient within 1e-4 of the reference's moves it by at most
lr min(2, 1e-4 eps / (|g| + eps)^2) more, which is what the stepped weights
are held to (plus 1e-6); near g = 0 that sensitivity is AdamW's, not the
port's.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.models import params as pmod
from repro_torch.models import transformer
from repro_torch.models.steps import loss_and_grads, make_eval_step, make_train_step
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw
from tests.conftest import run_subprocess_py

# name -> (arch, config overrides, with a loss mask)
CASES = {
    "rsc-llm": ("rsc-llm", {}, False),
    "rsc-llm-chunked-masked": ("rsc-llm", {"loss_chunk": 8}, True),
    "qwen3-0.6b": ("qwen3-0.6b", {}, False),
    "rsc-llm-local": ("rsc-llm", {"block_groups": ((("local",), 2),), "window": 16}, False),
    "rwkv6-7b": ("rwkv6-7b", {}, False),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}, False),
    "recurrentgemma-9b-window": ("recurrentgemma-9b", {"window": 16}, False),
    "gemma3-4b": ("gemma3-4b", {}, False),
    "mixtral-8x22b": ("mixtral-8x22b", {}, False),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", {"window": 16}, False),
    "starcoder2-3b": ("starcoder2-3b", {}, False),
    "granite-20b": ("granite-20b", {}, False),
}
# cases also stepped with n_microbatches=2 (a microbatch of one row each)
MB_CASES = ("rsc-llm", "rsc-llm-chunked-masked", "rwkv6-7b", "recurrentgemma-9b",
            "gemma3-4b", "mixtral-8x22b", "qwen3-0.6b", "granite-20b")
B, S = 2, 32
ROOT = pathlib.Path(__file__).resolve().parents[1]
LR = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True)
def _one_thread():
    """Test workers share the CPU: one intra-op thread each keeps torch's
    thread pools from oversubscribing it (a trainer run is ~50x slower
    otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

JAX_SCRIPT = textwrap.dedent("""
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.manager import _flatten
    from repro.configs.base import get_arch, smoke_config
    from repro.models import params as pmod, transformer
    from repro.models.steps import make_train_step
    from repro.optim import adamw

    out = {}
    for name, (arch, over, masked) in %(cases)r.items():
        cfg = smoke_config(get_arch(arch)).replace(**over)
        params = pmod.materialize(transformer.model_defs(cfg), seed=3)
        rng = np.random.default_rng(11)
        batch = {"tokens": rng.integers(3, cfg.vocab_size, (%(B)d, %(S)d + 1), dtype=np.int32)}
        if masked:
            batch["mask"] = (rng.random((%(B)d, %(S)d)) < 0.7).astype(np.float32)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, metrics), grads = jax.value_and_grad(transformer.loss_fn, has_aux=True)(
            params, cfg, jb)
        step = jax.jit(make_train_step(cfg, adamw.AdamWConfig(**%(lr)r)))
        p1, _, m1 = step(params, adamw.init(params), jb)
        for k, v in batch.items():
            out[f"{name}/batch/{k}"] = v
        for k, v in metrics.items():
            out[f"{name}/metrics/{k}"] = np.asarray(v)
        for tag, tree in (("params", params), ("grads", grads), ("stepped", p1)):
            for path, leaf in _flatten(tree).items():
                out[f"{name}/{tag}/{path}"] = np.asarray(leaf)
        out[f"{name}/step_loss"] = np.asarray(m1["loss"])
        if name in %(mb_cases)r:
            step2 = jax.jit(make_train_step(cfg, adamw.AdamWConfig(**%(lr)r), n_microbatches=2))
            p2, _, m2 = step2(params, adamw.init(params), jb)
            # the reference's accumulation: f32 sum over the two halves, / 2
            half = %(B)d // 2
            gs = [jax.grad(lambda p, mb: transformer.loss_fn(p, cfg, mb)[0])(
                params, {k: v[i * half:(i + 1) * half] for k, v in jb.items()})
                for i in range(2)]
            g2 = jax.tree_util.tree_map(
                lambda a, b: (a.astype(jnp.float32) + b.astype(jnp.float32)) / 2, *gs)
            for tag, tree in (("stepped_mb2", p2), ("grads_mb2", g2)):
                for path, leaf in _flatten(tree).items():
                    out[f"{name}/{tag}/{path}"] = np.asarray(leaf)
            out[f"{name}/step_loss_mb2"] = np.asarray(m2["loss"])
    np.savez(%(path)r, **out)
""")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_train") / "ref.npz")
    r = run_subprocess_py(JAX_SCRIPT % {"cases": CASES, "path": path, "B": B, "S": S, "lr": LR,
                                        "mb_cases": MB_CASES},
                          env_extra={"REPRO_COMPUTE_DTYPE": "float32", "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _cfg(name):
    arch, over, _ = CASES[name]
    return smoke_config(get_arch(arch)).replace(**over)


def _sub(data, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in data.items() if k.startswith(prefix)}


def _batch(data, name):
    batch = _sub(data, f"{name}/batch/")
    batch["tokens"] = batch["tokens"].long()
    return batch


@pytest.mark.parametrize("name", CASES)
def test_loss_and_grads_match_jax(jax_run, name):
    cfg = _cfg(name)
    params = {k: v.requires_grad_() for k, v in _sub(jax_run, f"{name}/params/").items()}
    assert set(params) == {p for p, _ in pmod.flatten(transformer.model_defs(cfg))}
    loss, metrics = transformer.loss_fn(params, cfg, _batch(jax_run, name), dtype=torch.float32)
    want = _sub(jax_run, f"{name}/metrics/")
    assert set(metrics) == set(want)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
    grads = torch.autograd.grad(loss, list(params.values()))
    want_g = _sub(jax_run, f"{name}/grads/")
    for (path, p), g in zip(params.items(), grads):
        assert g.shape == p.shape
        np.testing.assert_allclose(g.numpy(), want_g[path].numpy(), atol=1e-4, err_msg=path)


@pytest.mark.parametrize("name", CASES)
def test_train_step_matches_jax(jax_run, name):
    cfg = _cfg(name)
    params = _sub(jax_run, f"{name}/params/")
    step = make_train_step(cfg, adamw.AdamWConfig(**LR), dtype=torch.float32)
    new, opt, metrics = step(params, adamw.init(params), _batch(jax_run, name))
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_run[f"{name}/step_loss"]),
                               atol=1e-5)
    _assert_stepped(new, _sub(jax_run, f"{name}/stepped/"), _sub(jax_run, f"{name}/grads/"))
    assert int(opt.step) == 1 and set(metrics) >= {"loss", "grad_norm", "lr"}


def _assert_stepped(new, want, grads):
    """The stepped weights against the reference's, to the tolerance the
    module docstring derives from the reference's gradients ``grads``."""
    opt_cfg = adamw.AdamWConfig(**LR)
    lr = float(adamw.schedule(opt_cfg, torch.tensor(1)))
    assert set(new) == set(want)
    for path, p in new.items():
        g = grads[path].abs().double()
        tol = 1e-6 + lr * torch.clamp(1e-4 * opt_cfg.eps / (g + opt_cfg.eps) ** 2, max=2.0)
        err = (p.double() - want[path].double()).abs()
        assert bool((err <= tol).all()), (path, float((err - tol).max()))


@pytest.mark.parametrize("name", MB_CASES)
def test_microbatched_step_matches_jax(jax_run, name):
    """n_microbatches=2 against the JAX package's: the accumulated gradients
    to 1e-4 (the reference's f32 sum over the halves, / 2), the loss to
    1e-5, the stepped weights as above.  Under a mask the halves count
    different tokens, so this is not the full batch's step."""
    cfg = _cfg(name)
    params = _sub(jax_run, f"{name}/params/")
    batch = _batch(jax_run, name)
    want_g = _sub(jax_run, f"{name}/grads_mb2/")
    _, _, grads = loss_and_grads(cfg, params, batch, n_microbatches=2, dtype=torch.float32)
    assert set(grads) == set(want_g)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[path].numpy(), atol=1e-4, err_msg=path)
    step = make_train_step(cfg, adamw.AdamWConfig(**LR), n_microbatches=2, dtype=torch.float32)
    new, _, metrics = step(params, adamw.init(params), batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jax_run[f"{name}/step_loss_mb2"]), atol=1e-5)
    _assert_stepped(new, _sub(jax_run, f"{name}/stepped_mb2/"), want_g)


def _np_batch(cfg, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, s + 1))).long()}


def test_train_step_with_microbatching_matches(jax_run):
    """Gradient accumulation over 2 microbatches is the full batch's
    gradient (the check of tests/test_smoke_archs.py, made exact): with no
    mask the mean of the halves' means is the full mean, so in f32 the
    loss and every gradient agree to 1e-5; a dropped microbatch or a
    missing / n is off by the gradient itself.  A batch that does not
    split raises."""
    cfg = _cfg("rsc-llm")
    params = _sub(jax_run, "rsc-llm/params/")
    batch = _batch(jax_run, "rsc-llm")
    loss1, _, g1 = loss_and_grads(cfg, params, batch, dtype=torch.float32)
    loss2, m2, g2 = loss_and_grads(cfg, params, batch, n_microbatches=2, dtype=torch.float32)
    assert abs(float(loss1) - float(loss2)) <= 1e-5 and set(m2) == {"loss", "ce_loss"}
    assert set(g1) == set(g2)
    for path, g in g2.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), g1[path].numpy(), atol=1e-5, err_msg=path)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, adamw.AdamWConfig(**LR), n_microbatches=3)(
            params, adamw.init(params), batch)


def test_train_steps_learn_the_batch_and_eval_agrees():
    """Three bf16 steps lower the loss on one batch (tests/test_smoke_archs.py),
    and the eval step reports the train step's loss for the same weights."""
    cfg = smoke_config(get_arch("rsc-llm"))
    params = pmod.materialize(transformer.model_defs(cfg), seed=0)
    batch = _np_batch(cfg, b=2, s=64)
    step = make_train_step(cfg, adamw.AdamWConfig(**LR))
    ev = make_eval_step(cfg)
    opt = adamw.init(params)
    loss0 = float(ev(params, batch)["loss"])
    assert 1.0 < loss0 < 20.0
    losses = []
    for _ in range(3):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[0] == pytest.approx(loss0, abs=1e-6)
    assert losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 and not p.requires_grad for p in params.values())


def _loss_and_leaves(cfg, batch, dtype=torch.float32):
    """``loss_fn`` over f32 masters from ``pmod.materialize``, the trainer's
    path; returns (loss, metrics, masters)."""
    masters = {k: v.requires_grad_() for k, v in
               pmod.materialize(transformer.model_defs(cfg), seed=0).items()}
    loss, metrics = transformer.loss_fn(masters, cfg, batch, dtype=dtype)
    return loss, metrics, masters


def test_remat_leaves_loss_and_grads_unchanged():
    """remat_policy "full" (each layer recomputed in the backward) and
    "none" give the same loss and gradients (the selective policies:
    tests/test_torch_remat.py)."""
    cfg = smoke_config(get_arch("rsc-llm"))
    batch = _np_batch(cfg, b=2, s=16)
    out = {}
    for policy in ("full", "none"):
        loss, _, masters = _loss_and_leaves(cfg.replace(remat_policy=policy), batch)
        out[policy] = [loss.detach()] + list(torch.autograd.grad(loss, list(masters.values())))
    for a, b in zip(out["full"], out["none"]):
        assert torch.equal(a, b)


def test_master_weights_train_and_serving_stays_frozen():
    """f32 masters under bf16 compute get f32 gradients through the cast;
    a serving model's weights are in the compute dtype and do not require
    grad."""
    cfg = smoke_config(get_arch("rsc-llm"))
    loss, metrics, masters = _loss_and_leaves(cfg, _np_batch(cfg, b=2, s=16),
                                              dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in masters.values())
    grads = torch.autograd.grad(loss, list(masters.values()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)
    assert float(metrics["tokens"]) == 2 * 16
    serve = Transformer(cfg, device="cpu")
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in serve.parameters())


def test_recurrentgemma_trains_through_the_launcher_on_cpu(tmp_path):
    """``launch/train.py --arch recurrentgemma-9b --smoke --device cpu``
    trains the hybrid through the trainer, a crash and a restore included,
    and its loss falls on the pipeline's batches."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "recurrentgemma-9b",
           "--smoke", "--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "32",
           "--ckpt-every", "2", "--inject-rate", "0.3", "--ckpt-dir", str(tmp_path / "ck")]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout)
    assert rep["arch"] == "recurrentgemma-9b-smoke" and rep["final_step"] == 6
    assert rep["attempts"] >= 2 and 0.0 < rep["measured_ettr"] <= 1.0
    assert np.isfinite(rep["loss_first"]) and rep["loss_last"] < rep["loss_first"]


def test_moe_metrics_reach_the_train_step():
    """The MoE aux means leave loss_and_grads and the train step as the
    reference's loss_fn reports them, beside the optimizer's metrics."""
    cfg = _cfg("mixtral-8x22b")
    params = pmod.materialize(transformer.model_defs(cfg), seed=0)
    batch = _np_batch(cfg, b=2, s=32)
    _, metrics, _ = loss_and_grads(cfg, params, batch, dtype=torch.float32)
    assert {"moe_lb_loss", "moe_z_loss", "moe_dropped"} <= set(metrics)
    _, _, m = make_train_step(cfg, adamw.AdamWConfig(**LR), dtype=torch.float32)(
        params, adamw.init(params), batch)
    assert {"moe_lb_loss", "moe_z_loss", "moe_dropped", "grad_norm", "lr"} <= set(m)
    assert 0.0 <= float(m["moe_dropped"]) < 1.0 and float(m["moe_lb_loss"]) > 0.0


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_trains_through_the_launcher_on_cpu(tmp_path, arch):
    """``launch/train.py --arch <MoE arch> --smoke --device cpu`` trains
    through the trainer, a crash and a restore included."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
           "--smoke", "--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "32",
           "--ckpt-every", "2", "--inject-rate", "0.3", "--ckpt-dir", str(tmp_path / "ck")]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout)
    assert rep["arch"] == f"{arch}-smoke" and rep["final_step"] == 6
    assert rep["attempts"] >= 2 and np.isfinite(rep["loss_first"])
    assert rep["loss_last"] < rep["loss_first"]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_recurrent_remat_leaves_loss_and_grads_unchanged(arch):
    """The recurrent blocks under remat "full": each runs twice, on a fresh
    state each time (its kernels update a given state in place), and the
    loss and every gradient equal the run without remat, bit for bit."""
    cfg = smoke_config(get_arch(arch))
    batch = _np_batch(cfg, b=2, s=16)
    out = {}
    for policy in ("full", "none"):
        loss, _, masters = _loss_and_leaves(cfg.replace(remat_policy=policy), batch)
        out[policy] = [loss.detach()] + list(torch.autograd.grad(loss, list(masters.values())))
    for a, b in zip(out["full"], out["none"]):
        assert torch.equal(a, b)
