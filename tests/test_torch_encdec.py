"""The encoder-decoder slice (smoke seamless-m4t-large-v2): repro_torch
against the JAX package on the same weights, frames and tokens.

A subprocess with REPRO_COMPUTE_DTYPE=float32 (read when repro is imported)
materializes f32 JAX params for each case of CASES and, from a numpy seed,
a (B, S + 1) token batch with its frontend stubs (frames (B, Se, d) of std
0.1, or patches (B, P, d)).  On the first S tokens it runs the prefill, 4
greedy decode steps and saves the logits, the greedy tokens and the
prefill's caches (k, v and the cross caches xk, xv); on the S + 1 tokens
it takes ``jax.value_and_grad(transformer.loss_fn)``, one
``make_train_step`` step, and the same step with ``n_microbatches=2`` (the
stubs split along the batch as the tokens are) with the halves' f32
gradient sum / 2.  The port loads the same weights and runs in f32 on the
CPU.  Cases here: seamless at Se = S, S / 2 and 2 S.  Beside them: the
port's Server against the JAX Server (zero frames, bf16 weights), both
trainers failing on an encoder-decoder config (their pipelines yield no
frames), the launcher, ``ops.flash_attention`` without a mask at Sq != Sk
against the reference's oracle and its blocked ``_flash`` (forward and
gradients), and the reference's parameter counts.

Tolerances (tests/test_torch_serve.py, tests/test_torch_train.py): 1e-4 on
logits, caches and gradients, 1e-5 on the loss and the metrics; flash
attention 1e-5 forward and 5e-5 gradients (tests/test_torch_flash_bwd.py).
"""
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.kernels import ops as jops
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.kernels import ops
from repro_torch.models import convert
from repro_torch.models import params as pmod
from repro_torch.models import transformer
from repro_torch.models.steps import (loss_and_grads, make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw
from repro_torch.runtime.serve_loop import ServeConfig, Server
from repro_torch.runtime.train_loop import FaultTolerantTrainer, TrainerConfig
from tests.conftest import run_subprocess_py

ARCH = "seamless-m4t-large-v2"
B, S = 2, 32
N_DECODE = 4
ATOL = 1e-4
LR = dict(lr=1e-3, warmup_steps=2, total_steps=10)
ROOT = pathlib.Path(__file__).resolve().parents[1]
# name -> (arch, config overrides, frames Se, patches P, text tokens S)
CASES = {
    "seamless": (ARCH, {}, S, 0, S),
    "seamless-half-frames": (ARCH, {}, S // 2, 0, S),
    "seamless-double-frames": (ARCH, {}, 2 * S, 0, S),
}
SERVE = dict(batch=2, prompt_len=16, max_new_tokens=6)

JAX_SCRIPT = textwrap.dedent("""
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.manager import _encode, _flatten
    from repro.configs.base import get_arch, smoke_config
    from repro.models import params as pmod, transformer
    from repro.models.steps import make_decode_step, make_prefill_step, make_train_step
    from repro.optim import adamw
    from repro.runtime.serve_loop import ServeConfig, Server
    from repro.runtime.train_loop import FaultTolerantTrainer, TrainerConfig

    B = %(B)d
    out = {}
    for name, (arch, over, n_frames, n_patches, S) in %(cases)r.items():
        cfg = smoke_config(get_arch(arch)).replace(**over)
        params = pmod.materialize(transformer.model_defs(cfg), seed=3)
        rng = np.random.default_rng(11)
        tokens = rng.integers(3, cfg.vocab_size, (B, S + 1), dtype=np.int32)
        stubs = {}
        if n_frames:
            stubs["frames"] = (0.1 * rng.standard_normal((B, n_frames, cfg.d_model))).astype(np.float32)
        if n_patches:
            stubs["patches"] = (0.1 * rng.standard_normal((B, n_patches, cfg.d_model))).astype(np.float32)
        js = {k: jnp.asarray(v) for k, v in stubs.items()}
        logits, cache = jax.jit(make_prefill_step(cfg))(
            params, dict(js, tokens=jnp.asarray(tokens[:, :S])))
        out[name + "/pos"] = np.asarray(cache["pos"])
        for key, t in cache["groups"][0]["p0"].items():
            out[name + "/cache/" + key] = np.asarray(t, np.float32)
        decode = jax.jit(make_decode_step(cfg))
        seq, greedy = [logits], []
        for _ in range(%(n)d):
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            greedy.append(tok)
            logits, cache = decode(params, cache, tok[:, None])
            seq.append(logits)
        out[name + "/logits"] = np.stack([np.asarray(l, np.float32) for l in seq])
        out[name + "/greedy"] = np.stack([np.asarray(t) for t in greedy])
        batch = dict(stubs, tokens=tokens)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, metrics), grads = jax.value_and_grad(transformer.loss_fn, has_aux=True)(
            params, cfg, jb)
        opt = adamw.AdamWConfig(**%(lr)r)
        p1, _, m1 = jax.jit(make_train_step(cfg, opt))(params, adamw.init(params), jb)
        p2, _, m2 = jax.jit(make_train_step(cfg, opt, n_microbatches=2))(
            params, adamw.init(params), jb)
        half = B // 2
        gs = [jax.grad(lambda p, mb: transformer.loss_fn(p, cfg, mb)[0])(
            params, {k: v[i * half:(i + 1) * half] for k, v in jb.items()}) for i in range(2)]
        g2 = jax.tree_util.tree_map(
            lambda a, b: (a.astype(jnp.float32) + b.astype(jnp.float32)) / 2, *gs)
        for k, v in batch.items():
            out[f"{name}/batch/{k}"] = v
        for k, v in metrics.items():
            out[f"{name}/metrics/{k}"] = np.asarray(v)
        for tag, tree in (("params", params), ("grads", grads), ("stepped", p1),
                          ("stepped_mb2", p2), ("grads_mb2", g2)):
            for path, leaf in _flatten(tree).items():
                out[f"{name}/{tag}/{path}"] = np.asarray(leaf)
        out[name + "/step_loss"] = np.asarray(m1["loss"])
        out[name + "/step_loss_mb2"] = np.asarray(m2["loss"])
    for arch in %(server_archs)r:
        cfg = smoke_config(get_arch(arch))
        srv = Server(cfg, ServeConfig(**%(serve)r))
        out[arch + "/server_outputs"] = srv.run().outputs
        for path, leaf in _flatten(srv.params).items():
            out[arch + "/server_params/" + path] = _encode(leaf)[0]
    for arch in %(trainer_archs)r:
        tcfg = TrainerConfig(total_steps=1, global_batch=2, seq_len=16, ckpt_every_steps=1,
                             ckpt_async=False, ckpt_dir=%(ckpt)r + "/" + arch)
        try:
            FaultTolerantTrainer(smoke_config(get_arch(arch)), tcfg).run()
            out[arch + "/trainer_error"] = np.asarray("none")
        except KeyError as e:
            out[arch + "/trainer_error"] = np.asarray("KeyError " + str(e))
    np.savez(%(path)r, **out)
""")


def run_jax(tmp_path_factory, cases, server_archs=(), trainer_archs=()):
    """JAX_SCRIPT over ``cases`` in a subprocess; its npz as a dict."""
    tmp = tmp_path_factory.mktemp("jax_ref")
    path = str(tmp / "ref.npz")
    r = run_subprocess_py(
        JAX_SCRIPT % {"cases": cases, "B": B, "n": N_DECODE, "lr": LR, "path": path,
                      "server_archs": tuple(server_archs), "serve": SERVE,
                      "trainer_archs": tuple(trainer_archs), "ckpt": str(tmp / "ckpt")},
        env_extra={"REPRO_COMPUTE_DTYPE": "float32", "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return run_jax(tmp_path_factory, CASES, server_archs=(ARCH,),
                   trainer_archs=(ARCH, "rsc-llm"))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sub(data, prefix):
    return {k[len(prefix):]: v for k, v in data.items() if k.startswith(prefix)}


def case_config(cases, name):
    arch, over, *_ = cases[name]
    return smoke_config(get_arch(arch)).replace(**over)


def case_batch(data, name, n_text=None):
    """The case's batch as torch tensors; ``n_text`` keeps the first tokens."""
    batch = {k: torch.from_numpy(v) for k, v in sub(data, f"{name}/batch/").items()}
    batch["tokens"] = batch["tokens"].long()
    if n_text is not None:
        batch["tokens"] = batch["tokens"][:, :n_text]
    return batch


def check_prefill_cache_and_decode(data, cases, name):
    """The port's prefill logits, caches and "pos", then N_DECODE greedy
    steps, against the JAX package's."""
    cfg = case_config(cases, name)
    n_text = cases[name][4]
    model = convert.load_into(Transformer(cfg, device="cpu", dtype=torch.float32),
                              sub(data, f"{name}/params/"))
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, cache = prefill(case_batch(data, name, n_text))
    assert cache["pos"] == int(data[f"{name}/pos"])
    want_cache = sub(data, f"{name}/cache/")
    assert set(cache["groups"][0]["p0"]) == set(want_cache)
    for key, t in cache["groups"][0]["p0"].items():
        assert tuple(t.shape) == want_cache[key].shape, key
        np.testing.assert_allclose(t.numpy(), want_cache[key], atol=ATOL, err_msg=key)
    seq, greedy = [logits], []
    for _ in range(N_DECODE):
        tok = logits[:, -1].argmax(-1)
        greedy.append(tok)
        logits, cache = decode(cache, tok[:, None])
        seq.append(logits)
    np.testing.assert_allclose(torch.stack(seq).numpy(), data[f"{name}/logits"], atol=ATOL)
    np.testing.assert_array_equal(torch.stack(greedy).numpy(), data[f"{name}/greedy"])
    return cfg, cache


def check_loss_and_grads(data, cases, name):
    cfg = case_config(cases, name)
    params = {k: torch.from_numpy(v).requires_grad_()
              for k, v in sub(data, f"{name}/params/").items()}
    assert set(params) == {p for p, _ in pmod.flatten(transformer.model_defs(cfg))}
    loss, metrics = transformer.loss_fn(params, cfg, case_batch(data, name), dtype=torch.float32)
    want = sub(data, f"{name}/metrics/")
    assert set(metrics) == set(want)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], atol=1e-5, err_msg=k)
    grads = torch.autograd.grad(loss, list(params.values()))
    want_g = sub(data, f"{name}/grads/")
    for (path, p), g in zip(params.items(), grads):
        assert g.shape == p.shape
        np.testing.assert_allclose(g.numpy(), want_g[path], atol=ATOL, err_msg=path)


def check_stepped(new, want, grads):
    """Stepped weights against the reference's, to the bound
    tests/test_torch_train.py derives from the gradients' tolerance."""
    opt_cfg = adamw.AdamWConfig(**LR)
    lr = float(adamw.schedule(opt_cfg, torch.tensor(1)))
    assert set(new) == set(want)
    for path, p in new.items():
        g = torch.from_numpy(grads[path]).abs().double()
        tol = 1e-6 + lr * torch.clamp(1e-4 * opt_cfg.eps / (g + opt_cfg.eps) ** 2, max=2.0)
        err = (p.double() - torch.from_numpy(want[path]).double()).abs()
        assert bool((err <= tol).all()), (path, float((err - tol).max()))


def check_train_steps(data, cases, name):
    """One make_train_step step, and one with n_microbatches=2 (its
    accumulated gradients too), against the JAX package's."""
    cfg = case_config(cases, name)
    params = {k: torch.from_numpy(v) for k, v in sub(data, f"{name}/params/").items()}
    batch = case_batch(data, name)
    step = make_train_step(cfg, adamw.AdamWConfig(**LR), dtype=torch.float32)
    new, _, metrics = step(params, adamw.init(params), batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(data[f"{name}/step_loss"]),
                               atol=1e-5)
    check_stepped(new, sub(data, f"{name}/stepped/"), sub(data, f"{name}/grads/"))
    want_g = sub(data, f"{name}/grads_mb2/")
    _, _, grads = loss_and_grads(cfg, params, batch, n_microbatches=2, dtype=torch.float32)
    assert set(grads) == set(want_g)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_g[path], atol=ATOL, err_msg=path)
    step2 = make_train_step(cfg, adamw.AdamWConfig(**LR), n_microbatches=2, dtype=torch.float32)
    new, _, metrics = step2(params, adamw.init(params), batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(data[f"{name}/step_loss_mb2"]),
                               atol=1e-5)
    check_stepped(new, sub(data, f"{name}/stepped_mb2/"), want_g)


@pytest.mark.parametrize("name", CASES)
def test_prefill_cache_and_decode_match_jax(jax_run, name):
    cfg, cache = check_prefill_cache_and_decode(jax_run, CASES, name)
    xk = cache["groups"][0]["p0"]["xk"]
    # the cross caches hold every frame, stacked over the decoder's layers
    assert tuple(xk.shape) == (cfg.n_layers, B, CASES[name][2], cfg.n_kv_heads, cfg.d_head)


@pytest.mark.parametrize("name", CASES)
def test_loss_and_grads_match_jax(jax_run, name):
    check_loss_and_grads(jax_run, CASES, name)


@pytest.mark.parametrize("name", CASES)
def test_train_steps_match_jax(jax_run, name):
    check_train_steps(jax_run, CASES, name)


def test_frames_reach_the_decoder(jax_run):
    """Other frames give other logits: the decoder reads the encoder."""
    cfg = case_config(CASES, "seamless")
    model = convert.load_into(Transformer(cfg, device="cpu", dtype=torch.float32),
                              sub(jax_run, "seamless/params/"))
    batch = case_batch(jax_run, "seamless", S)
    a, _ = make_prefill_step(model)(batch)
    b, _ = make_prefill_step(model)(dict(batch, frames=-batch["frames"]))
    assert (a - b).abs().max().item() > 1e-3


def test_server_tokens_match_jax_server(jax_run):
    """The port's Server sends the reference Server's zero frames."""
    cfg = smoke_config(get_arch(ARCH))
    params = convert.from_jax_params(sub(jax_run, f"{ARCH}/server_params/"))
    rep = Server(cfg, ServeConfig(**SERVE), device="cpu", dtype=torch.float32,
                 params=params).run()
    np.testing.assert_array_equal(rep.outputs, jax_run[f"{ARCH}/server_outputs"])


def test_both_trainers_fail_on_an_encoder_decoder_config(jax_run, tmp_path):
    """The synthetic pipeline yields tokens only, so the reference's trainer
    and the port's both fail at their first step on the missing frames; a
    decoder-only config trains in both."""
    assert str(jax_run[f"{ARCH}/trainer_error"]) == "KeyError 'frames'"
    assert str(jax_run["rsc-llm/trainer_error"]) == "none"
    tcfg = TrainerConfig(total_steps=1, global_batch=2, seq_len=16, ckpt_every_steps=1,
                         ckpt_async=False, ckpt_dir=str(tmp_path / "ck"))
    with pytest.raises(KeyError, match="frames"):
        FaultTolerantTrainer(smoke_config(get_arch(ARCH)), tcfg, device="cpu").run()


def test_serve_launcher_takes_seamless_on_cpu():
    """``launch/serve.py --arch seamless-m4t-large-v2 --smoke --device cpu``
    serves every request, a decode crash replayed included."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
           "--device", "cpu", "--batch", "2", "--prompt-len", "16", "--new-tokens", "4",
           "--inject-rate", "0.3", "--seed", "1"]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout)
    assert rep["arch"] == f"{ARCH}-smoke" and rep["requests"] == 2 and rep["tokens"] == 8


@pytest.mark.parametrize("arch,want", [("seamless-m4t-large-v2", 1_632_131_072),
                                       ("llava-next-34b", 34_388_917_248)])
def test_param_count_matches_the_reference(arch, want):
    """The reference's parameter accounting, and at these two configs the
    model's own weights, at smoke size (the full ones are not built)."""
    assert get_arch(arch).param_count() == jget_arch(arch).param_count() == want
    cfg = smoke_config(get_arch(arch))
    n = sum(math.prod(d.shape) for _, d in pmod.flatten(transformer.model_defs(cfg)))
    assert n == cfg.param_count()


# -- flash attention without a mask at Sq != Sk (cross-attention) -------------
# (B, Sq, Sk, H, KV, D): the reference's oracle (Sq Sk <= 1024^2), then its
# blocked _flash (Sq Sk > 1024^2), at GQA and MHA
FLASH_CASES = [(2, 48, 20, 4, 2, 16), (1, 300, 700, 4, 2, 64), (1, 1100, 1000, 2, 2, 64)]


def _flash_inputs(case, seed=0):
    B, Sq, Sk, H, KV, D = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D))]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_without_mask_at_sq_ne_sk_matches_the_reference(case):
    """ops.flash_attention(causal=False) at Sq != Sk against the reference's
    ops.flash_attention (its oracle, or its blocked _flash past 1024^2), and
    its gradients, through the FlashAttention Function, against jax.grad."""
    q, k, v, do = _flash_inputs(case)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=False))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=False)
    assert type(got.grad_fn).__name__ == "FlashAttentionBackward"
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    want_g = jax.grad(lambda a, b, c: (jops.flash_attention(a, b, c, causal=False) * do).sum(),
                      argnums=(0, 1, 2))(jq, jk, jv)
    got_g = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, err_msg=f"d{name}")
    with torch.inference_mode():
        served = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=False)
    np.testing.assert_allclose(served.numpy(), want, atol=1e-5)


def test_a_mask_at_sq_ne_sk_stays_off_the_card_path():
    """A causal mask, a window, a chunk or q_offset at Sq != Sk goes to the
    kernel wrappers like any other shape: the plain version on the CPU, and
    for a tensor on neither the CPU nor the card a raise, with no
    fallback."""
    q, k, v, _ = _flash_inputs(FLASH_CASES[0])
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = np.asarray(jops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True))
    np.testing.assert_allclose(ops.flash_attention(tq, tk, tv).numpy(), want, atol=1e-5)
    meta = [t.to("meta") for t in (tq, tk, tv)]
    for kw in (dict(), dict(causal=False, window=8), dict(causal=False, chunk=8),
               dict(causal=False, q_offset=4)):
        with pytest.raises(ValueError, match="unsupported device"):
            ops.flash_attention(*meta, **kw)
