"""The decoder-only features of this slice: patch embeddings in front of the
tokens (smoke llava-next-34b) and the attention logit softcap, repro_torch
against the JAX package on the same weights and inputs.

The JAX side is tests/test_torch_encdec.py's subprocess (JAX_SCRIPT), here
over these CASES: prefill, caches and 4 greedy decode steps; the loss,
metrics and gradients of ``transformer.loss_fn``; one ``make_train_step``
step and one with ``n_microbatches=2``.  llava runs with its 16 smoke
patches and 16 text tokens, so the joined length S = 32 differs from the
text length: the cache's "pos" and the decode's RoPE positions must count
the patches.  Softcap 30 moves smoke logits by ~2e-5, under
the tolerance, so softcap 1 is held too, where it moves them by
~2e-2.  Tolerances as there: 1e-4 on logits, caches and gradients, 1e-5 on
the loss and the metrics.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.models import convert
from repro_torch.models.steps import make_prefill_step
from repro_torch.models.transformer import Transformer
from tests.test_torch_encdec import (case_batch, case_config, check_loss_and_grads,
                                     check_prefill_cache_and_decode, check_train_steps, run_jax,
                                     sub)

ARCH = "llava-next-34b"
P = 16  # smoke_config's n_patches
# name -> (arch, config overrides, frames Se, patches P, text tokens S)
CASES = {
    "llava": (ARCH, {}, 0, P, 16),
    "softcap-30": ("rsc-llm", {"attn_logit_softcap": 30.0}, 0, 0, 32),
    "softcap-1": ("rsc-llm", {"attn_logit_softcap": 1.0}, 0, 0, 32),
}
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return run_jax(tmp_path_factory, CASES)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CASES)
def test_prefill_cache_and_decode_match_jax(jax_run, name):
    cfg, cache = check_prefill_cache_and_decode(jax_run, CASES, name)
    if name == "llava":
        # patches and text share the cache and the positions
        assert cache["pos"] == P + 16 + 4
        assert cache["groups"][0]["p0"]["k"].shape[2] == P + 16


@pytest.mark.parametrize("name", CASES)
def test_loss_and_grads_match_jax(jax_run, name):
    check_loss_and_grads(jax_run, CASES, name)


@pytest.mark.parametrize("name", CASES)
def test_train_steps_match_jax(jax_run, name):
    check_train_steps(jax_run, CASES, name)


def test_patches_change_the_text_logits_and_the_features_are_real(jax_run):
    """Without patches llava serves its text alone (the Server's batch): the
    logits move.  Without the softcap the softcap-1 model's logits move."""
    cfg = case_config(CASES, "llava")
    model = convert.load_into(Transformer(cfg, device="cpu", dtype=torch.float32),
                              sub(jax_run, "llava/params/"))
    batch = case_batch(jax_run, "llava", 16)
    with_p, cache = make_prefill_step(model)(batch)
    text, cache_t = make_prefill_step(model)({"tokens": batch["tokens"]})
    assert cache["pos"] == P + 16 and cache_t["pos"] == 16
    assert (with_p - text).abs().max().item() > 1e-3
    capped = case_config(CASES, "softcap-1")
    logits = {}
    for sc in (capped.attn_logit_softcap, 0.0):
        m = convert.load_into(
            Transformer(capped.replace(attn_logit_softcap=sc), device="cpu", dtype=torch.float32),
            sub(jax_run, "softcap-1/params/"))
        logits[sc], _ = make_prefill_step(m)(case_batch(jax_run, "softcap-1", 32))
    assert (logits[1.0] - logits[0.0]).abs().max().item() > 1e-3


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_take_llava_on_cpu(launcher, tmp_path):
    """``launch/serve.py`` and ``launch/train.py`` with ``--arch
    llava-next-34b --smoke --device cpu``: the Server and the trainer send
    no patches (as the reference's), so llava serves and trains its text."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch", ARCH, "--smoke",
           "--device", "cpu", "--batch", "2"]
    if launcher == "serve":
        cmd += ["--prompt-len", "16", "--new-tokens", "4"]
    else:
        cmd += ["--steps", "6", "--seq", "32", "--ckpt-every", "2",
                "--ckpt-dir", str(tmp_path / "ck")]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout)
    assert rep["arch"] == f"{ARCH}-smoke"
    if launcher == "train":
        assert rep["final_step"] == 6 and rep["loss_last"] < rep["loss_first"]


def test_smoke_llava_keeps_the_reference_patch_count():
    assert smoke_config(get_arch(ARCH)).n_patches == P and get_arch(ARCH).n_patches == 576
