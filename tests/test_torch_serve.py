"""The serving slice as a whole: repro_torch against the JAX package on the
same weights, and the port's Server on the CPU.

A subprocess with REPRO_COMPUTE_DTYPE=float32 (read when repro is imported)
materializes JAX params for smoke rsc-llm, qwen3-0.6b, rwkv6-7b,
recurrentgemma-9b, gemma3-4b, granite-20b, starcoder2-3b, mixtral-8x22b and
llama4-scout-17b-a16e, cast to bf16 as the JAX Server casts them, runs
prefill + 6 greedy decode steps and the JAX Server, and saves weights
(checkpoint encoding), logits and tokens to an npz; for recurrentgemma-9b it
also saves one decode step after prompts of 32, 64 and 80 tokens (its local
ring at window 64), and for llama4-scout-17b-a16e prefill + 6 decode steps
with chunks of 8 and 12 over the 16-token prompt (CHUNKS).  The port loads
the same weights and runs in f32 on the CPU.
Tolerance 1e-4 on logits: two layers of f32 matmuls summed in different
orders by two frameworks.  Greedy tokens must be equal.
"""
import dataclasses
import json
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

from repro.checkpoint.manager import _flatten
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke
from repro.models import transformer as jtransformer
from repro_torch.configs.base import MoESpec, get_arch, list_archs, smoke_config
from repro_torch.models import convert
from repro_torch.models import params as pmod
from repro_torch.models.steps import make_decode_step, make_prefill_step
from repro_torch.models.transformer import Transformer, loss_fn, model_defs
from repro_torch.runtime.fault_injection import FaultInjector, InjectedFault
from repro_torch.runtime.serve_loop import ServeConfig, Server
from tests.conftest import run_subprocess_py

ARCHS = ("rsc-llm", "qwen3-0.6b", "rwkv6-7b", "recurrentgemma-9b", "gemma3-4b",
         "granite-20b", "starcoder2-3b", "mixtral-8x22b", "llama4-scout-17b-a16e")
CHUNKS = (8, 12)  # llama4-scout's chunked layers: a chunk that divides S = 16, one that does not
RING_PROMPTS = (32, 64, 80)  # below, at and past the smoke window of 64
N_DECODE = 6
ATOL = 1e-4

JAX_SCRIPT = textwrap.dedent("""
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.manager import _encode, _flatten
    from repro.configs.base import get_arch, smoke_config
    from repro.models import params as pmod, transformer
    from repro.models.steps import make_decode_step, make_prefill_step
    from repro.runtime.serve_loop import ServeConfig, Server

    out = {}
    for arch in %(archs)r:
        cfg = smoke_config(get_arch(arch))
        params = pmod.materialize(
            pmod.cast_defs(transformer.model_defs(cfg), jnp.bfloat16), seed=3)
        tokens = np.random.default_rng(7).integers(3, cfg.vocab_size, (2, 16), dtype=np.int32)
        logits, cache = jax.jit(make_prefill_step(cfg))(params, {"tokens": jnp.asarray(tokens)})
        decode = jax.jit(make_decode_step(cfg))
        all_logits, greedy = [logits], []
        for _ in range(%(n)d):
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            greedy.append(tok)
            logits, cache = decode(params, cache, tok[:, None])
            all_logits.append(logits)
        out[arch + "/tokens"] = tokens
        out[arch + "/logits"] = np.stack([np.asarray(l, np.float32) for l in all_logits])
        out[arch + "/greedy"] = np.stack([np.asarray(t) for t in greedy])
        for path, leaf in _flatten(params).items():
            out[arch + "/params/" + path] = _encode(leaf)[0]
        srv = Server(cfg, ServeConfig(batch=2, prompt_len=16, max_new_tokens=6))
        out[arch + "/server_outputs"] = srv.run().outputs
        for path, leaf in _flatten(srv.params).items():
            out[arch + "/server_params/" + path] = _encode(leaf)[0]
        if arch == "recurrentgemma-9b":
            prefill = jax.jit(make_prefill_step(cfg))
            for S in %(ring)r:
                toks = np.random.default_rng(9).integers(3, cfg.vocab_size, (2, S + 1),
                                                         dtype=np.int32)
                _, cache = prefill(params, {"tokens": jnp.asarray(toks[:, :S])})
                logits, _ = decode(params, cache, jnp.asarray(toks[:, S:]))
                out[f"ring/{S}/tokens"] = toks
                out[f"ring/{S}/decode"] = np.asarray(logits, np.float32)
        if arch == "llama4-scout-17b-a16e":
            for chunk in %(chunks)r:
                ccfg = cfg.replace(window=chunk)
                logits, cache = jax.jit(make_prefill_step(ccfg))(params, {"tokens": jnp.asarray(tokens)})
                cdecode = jax.jit(make_decode_step(ccfg))
                seq = [logits]
                for _ in range(%(n)d):
                    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
                    logits, cache = cdecode(params, cache, tok[:, None])
                    seq.append(logits)
                out[f"chunk/{chunk}/logits"] = np.stack([np.asarray(l, np.float32) for l in seq])
    np.savez(%(path)r, **out)
""")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_serve") / "ref.npz")
    r = run_subprocess_py(JAX_SCRIPT % {"archs": ARCHS, "n": N_DECODE, "path": path,
                                        "ring": RING_PROMPTS, "chunks": CHUNKS},
                          env_extra={"REPRO_COMPUTE_DTYPE": "float32",
                                     "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    data = np.load(path)
    return {k: data[k] for k in data.files}


def _sub(data, prefix):
    return {k[len(prefix):]: v for k, v in data.items() if k.startswith(prefix)}


def _port_model(data, arch, key="params"):
    cfg = smoke_config(get_arch(arch))
    model = Transformer(cfg, device="cpu", dtype=torch.float32)
    return convert.load_into(model, _sub(data, f"{arch}/{key}/"))


def _port_greedy(model, tokens, n):
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, cache = prefill({"tokens": tokens})
    all_logits, greedy = [logits], []
    for _ in range(n):
        tok = logits[:, -1].argmax(-1)
        greedy.append(tok)
        logits, cache = decode(cache, tok[:, None])
        all_logits.append(logits)
    return torch.stack(all_logits).numpy(), torch.stack(greedy).numpy(), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(jax_run, arch):
    model = _port_model(jax_run, arch)
    tokens = torch.from_numpy(jax_run[f"{arch}/tokens"]).long()
    logits, greedy, cache = _port_greedy(model, tokens, N_DECODE)
    assert logits.shape == jax_run[f"{arch}/logits"].shape
    np.testing.assert_allclose(logits, jax_run[f"{arch}/logits"], atol=ATOL)
    np.testing.assert_array_equal(greedy, jax_run[f"{arch}/greedy"])
    assert cache["pos"] == tokens.shape[1] + N_DECODE


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_layers_prefill_and_decode_match_jax(jax_run, chunk):
    """llama4-scout's chunked layers with a chunk shorter than the prompt:
    the prefill masks attention to each query's chunk, and decode attends
    within the chunk of its position over the ring of the last min(chunk,
    S) keys, as the reference does (ring slots by the local layers' rule,
    exact when S is a multiple of the chunk, as 8 is; 12 is not, and the
    port keeps the reference's answer there too)."""
    arch = "llama4-scout-17b-a16e"
    model = _port_model(jax_run, arch)
    model.cfg = model.cfg.replace(window=chunk)
    assert model.cfg.kv_cache_len("chunked", 16) == chunk
    tokens = torch.from_numpy(jax_run[f"{arch}/tokens"]).long()
    logits, _, cache = _port_greedy(model, tokens, N_DECODE)
    np.testing.assert_allclose(logits, jax_run[f"chunk/{chunk}/logits"], atol=ATOL)
    assert cache["groups"][0]["p0"]["k"].shape[2] == chunk
    # the chunk is a real mask: the full prompt's logits move
    assert np.abs(logits[0] - jax_run[f"{arch}/logits"][0]).max() > 1e-3


def test_convert_takes_uint16_and_float32_bf16(jax_run):
    flat = _sub(jax_run, "rsc-llm/params/")
    assert flat["embed"].dtype == np.uint16
    as_f32 = {k: (v.astype(np.uint32) << 16).view(np.float32) for k, v in flat.items()}
    a, b = convert.from_jax_params(flat), convert.from_jax_params(as_f32)
    assert a["embed"].dtype == torch.bfloat16 and b["embed"].dtype == torch.float32
    for k in a:
        assert torch.equal(a[k].float(), b[k])
    with pytest.raises(RuntimeError, match="Missing"):
        model = Transformer(smoke_config(get_arch("rsc-llm")), device="cpu")
        convert.load_into(model, {k: v for k, v in flat.items() if k != "ln_f"})


def test_port_reproduces_ring_overwrite_at_pos_S(jax_run):
    """The prefill cache is exactly S long, so decode at pos S overwrites
    slot 0 (the reference's ring semantics).  The port keeps that: its
    first decode step differs from a full forward over S+1 tokens, agrees
    with the JAX decode, and matches full attention once spare slots are
    padded onto the cache."""
    arch = "rsc-llm"
    model = _port_model(jax_run, arch)
    tokens = torch.from_numpy(jax_run[f"{arch}/tokens"]).long()
    S = tokens.shape[1]
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, cache = prefill({"tokens": tokens})
    nxt = logits[:, -1].argmax(-1)[:, None]
    full_h, _ = model({"tokens": torch.cat([tokens, nxt], 1)})
    full = model.unembed(full_h[:, -1:])

    ring, _ = decode({"pos": S, "groups": _clone(cache["groups"])}, nxt)
    np.testing.assert_allclose(ring.numpy(), jax_run[f"{arch}/logits"][1], atol=ATOL)
    assert (ring - full).abs().max().item() > 1e-2

    padded = [{p: {k: torch.cat([t, torch.zeros_like(t[:, :, :4])], 2) for k, t in c.items()}
               for p, c in g.items()} for g in cache["groups"]]
    spare, _ = decode({"pos": S, "groups": padded}, nxt)
    np.testing.assert_allclose(spare.numpy(), full.numpy(), atol=ATOL)


def _clone(groups):
    return [{p: {k: t.clone() for k, t in c.items()} for p, c in g.items()} for g in groups]


@pytest.mark.parametrize("arch", ARCHS)
def test_server_tokens_match_jax_server(jax_run, arch):
    cfg = smoke_config(get_arch(arch))
    params = convert.from_jax_params(_sub(jax_run, f"{arch}/server_params/"))
    rep = Server(cfg, ServeConfig(batch=2, prompt_len=16, max_new_tokens=6),
                 device="cpu", dtype=torch.float32, params=params).run()
    np.testing.assert_array_equal(rep.outputs, jax_run[f"{arch}/server_outputs"])


# -- the port's Server (tests/test_runtime.py's serving cases) -----------------
@pytest.fixture
def cfg():
    return smoke_config(get_arch("rsc-llm"))


def test_server_retries_through_fault(cfg):
    srv = Server(cfg, ServeConfig(batch=2, prompt_len=16, max_new_tokens=6),
                 FaultInjector(schedule={2: InjectedFault("ib_link_error")}), device="cpu")
    rep = srv.run()
    assert rep.retries == 1
    assert rep.outputs.shape == (2, 6)


def test_server_output_deterministic(cfg):
    r1 = Server(cfg, ServeConfig(batch=2, prompt_len=16, max_new_tokens=6),
                device="cpu").run()
    r2 = Server(cfg, ServeConfig(batch=2, prompt_len=16, max_new_tokens=6),
                FaultInjector(schedule={3: InjectedFault("pcie_errors")}), device="cpu").run()
    # a mid-decode fault + full replay must yield identical tokens
    assert np.array_equal(r1.outputs, r2.outputs)
    assert r2.retries == 1


MOE = MoESpec(n_experts=4, top_k=2, capacity_factor=1.25, group_size=64)


@pytest.mark.parametrize("feature", ["unknown layer kind", "dots", "save_attn"])
def test_unported_features_raise(cfg, feature):
    """What the port refuses: a layer kind it does not know (a config that
    skipped ArchConfig's own check), when the model is built; a remat
    policy it does not know, under grad.  The policies "dots" and
    "save_attn" are ported: the model builds, and its loss under them
    equals its loss under "full"."""
    if feature == "unknown layer kind":
        bad = cfg.replace()
        object.__setattr__(bad, "block_groups", ((("mamba",), 2),))
        with pytest.raises(NotImplementedError, match="mamba"):
            Transformer(bad, device="cpu")
        return
    bad = cfg.replace(remat_policy=feature)
    Transformer(bad, device="cpu")
    leaves = {k: v.requires_grad_() for k, v in pmod.materialize(model_defs(bad)).items()}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(3, bad.vocab_size, (1, 9)))
    loss, _ = loss_fn(leaves, bad, {"tokens": tokens}, dtype=torch.float32)
    full, _ = loss_fn(leaves, cfg, {"tokens": tokens}, dtype=torch.float32)
    assert torch.equal(loss, full)
    with pytest.raises(ValueError, match="remat_policy"):
        loss_fn(leaves, cfg.replace(remat_policy=feature + "-unknown"), {"tokens": tokens},
                dtype=torch.float32)


@pytest.mark.parametrize("arch", list_archs())
def test_every_registered_architecture_builds(arch):
    """Each of the reference's architectures builds at smoke size with the
    reference's flatten paths and shapes, and prefills with its frontend
    stubs (frames for an encoder-decoder, patches for a VLM)."""
    cfg = smoke_config(get_arch(arch))
    model = Transformer(cfg, device="cpu", dtype=torch.float32)
    jflat = _flatten(jtransformer.model_defs(jsmoke(jget_arch(arch))))
    assert list(model.flat) == list(jflat)
    assert all(tuple(t.shape) == jflat[k].shape for k, t in model.flat.items())
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 8)))}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(rng.standard_normal((2, 6, cfg.d_model))).float()
    if cfg.n_patches:
        batch["patches"] = torch.from_numpy(
            rng.standard_normal((2, cfg.n_patches, cfg.d_model))).float()
    logits, cache = make_prefill_step(model)(batch)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size) and torch.isfinite(logits).all()
    assert cache["pos"] == 8 + cfg.n_patches


@pytest.mark.parametrize("feature", [
    dict(block_groups=((("chunked",), 2),), window=8),
    # mixtral-8x22b's MoE FFN at smoke size (8 experts top-2 -> 4, group 64)
    dict(moe=MOE),
])
def test_chunked_layers_and_moe_build(cfg, feature):
    model = Transformer(cfg.replace(**feature), device="cpu")
    assert ("groups/0/p0/moe/router" in model.flat) == ("moe" in feature)


def test_materialize_keeps_the_reference_init_rule():
    """std = scale / sqrt(prod(shape[:-1])) over the stacked shape, on the
    requested device, reproducible from the seed; names follow the
    reference's flatten order; a "custom" init (rwkv's decay w0) gives the
    reference's values up to f32 rounding."""
    defs = {"w": pmod.ParamDef((4, 64, 256), ("layers", "embed", "ff")),
            "g": pmod.ParamDef((8,), ("embed",), init="ones")}
    a, b = pmod.materialize(defs, seed=5), pmod.materialize(defs, seed=5)
    assert torch.equal(a["w"], b["w"]) and torch.equal(a["g"], torch.ones(8))
    assert abs(a["w"].std().item() * (4 * 64) ** 0.5 - 1.0) < 0.02
    flats = {}
    for arch in ("qwen3-0.6b", "rwkv6-7b", "recurrentgemma-9b", "mixtral-8x22b",
                 "llama4-scout-17b-a16e", "gemma3-4b", "granite-20b"):
        jdefs = jtransformer.model_defs(jsmoke(jget_arch(arch)))
        tdefs = model_defs(smoke_config(get_arch(arch)))
        jflat = _flatten(jdefs)  # ParamDefs are leaves of the JAX tree
        tflat = dict(pmod.flatten(tdefs))
        assert list(tflat) == list(jflat)
        assert all(tflat[k].shape == jflat[k].shape and tflat[k].init == jflat[k].init
                   and tflat[k].init_scale == jflat[k].init_scale for k in tflat)
        flats[arch] = jflat, tflat
    jflat, tflat = flats["rwkv6-7b"]
    custom = [k for k in tflat if tflat[k].init == "custom"]
    assert custom == ["groups/0/p0/w0"]
    want = jflat[custom[0]].init_fn(None, jflat[custom[0]].shape, jflat[custom[0]].dtype)
    got = pmod.materialize({"w0": tflat[custom[0]]}, seed=5)["w0"]
    # jnp.linspace and torch.linspace round differently in the last bit
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # rglru's lam: random, so the rule is checked, not the bits: the decay at
    # a gate of 1, exp(-8 softplus(lam)), is U(0.9, 0.999) in both packages
    jflat, tflat = flats["recurrentgemma-9b"]
    custom = sorted(k for k in tflat if tflat[k].init == "custom")
    assert custom == ["groups/0/p0/lam", "groups/0/p1/lam", "groups/1/p0/lam"]
    for k in custom:
        want = np.asarray(jflat[k].init_fn(jax.random.PRNGKey(5), (4096,), jnp.float32))
        got = pmod.materialize({"lam": dataclasses.replace(tflat[k], shape=(4096,),
                                                          axes=("lru",))},
                               seed=5)["lam"].numpy()
        for lam in (want, got):
            a = np.exp(-8.0 * np.logaddexp(lam, 0.0))
            assert 0.9 - 1e-5 <= a.min() and a.max() <= 0.999 + 1e-5
            assert abs(a.mean() - 0.9495) < 0.005


def test_convert_loads_moe_strictly(jax_run):
    """Every MoE key (router, experts, the shared expert) crosses over
    strictly, as the rest does."""
    flat = _sub(jax_run, "llama4-scout-17b-a16e/params/")
    model = Transformer(smoke_config(get_arch("llama4-scout-17b-a16e")), device="cpu",
                        dtype=torch.float32)
    assert set(flat) == set(model.flat)
    assert {"groups/0/p0/moe/router", "groups/0/p0/moe/w_gate", "groups/0/p0/moe/w_up",
            "groups/0/p0/moe/w_down", "groups/0/p0/moe/shared/w_gate"} <= set(flat)
    convert.load_into(model, flat)
    assert tuple(model.flat["groups/0/p0/moe/w_down"].shape) == (2, 4, 128, 64)
    with pytest.raises(RuntimeError, match="Missing"):
        convert.load_into(model, {k: v for k, v in flat.items() if k != "groups/0/p0/moe/router"})


def test_convert_loads_recurrentgemma_strictly(jax_run):
    """The JAX smoke params carry every rglru key (the ffn subtree too), and
    load_into takes them strictly: exactly the port's paths and shapes."""
    flat = _sub(jax_run, "recurrentgemma-9b/params/")
    model = Transformer(smoke_config(get_arch("recurrentgemma-9b")), device="cpu",
                        dtype=torch.float32)
    assert set(flat) == set(model.flat)
    assert {"groups/0/p0/lam", "groups/0/p0/ffn/w_gate", "groups/0/p2/attn/wq",
            "groups/1/p0/conv_w"} <= set(flat)
    convert.load_into(model, flat)
    for path, t in model.flat.items():
        assert tuple(t.shape) == flat[path].shape
    with pytest.raises(RuntimeError, match="Unexpected"):
        convert.load_into(model, dict(flat, **{"groups/0/p0/extra": flat["ln_f"]}))


@pytest.mark.parametrize("S", RING_PROMPTS)
def test_port_reproduces_local_ring_fault(jax_run, S):
    """The prefill keeps a local layer's last L = min(window, S) keys in
    linear order, while decode takes position p to sit at slot p % L: true
    only when S is a multiple of L and S >= window.  At window 64 a prompt
    of 64 decodes as a full forward over 65 tokens does; prompts of 80 and
    32 do not, and the port agrees with the JAX decode in every case."""
    arch = "recurrentgemma-9b"
    model = _port_model(jax_run, arch)
    toks = torch.from_numpy(jax_run[f"ring/{S}/tokens"]).long()
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    _, cache = prefill({"tokens": toks[:, :S]})
    got, _ = decode(cache, toks[:, S:])
    np.testing.assert_allclose(got.numpy(), jax_run[f"ring/{S}/decode"], atol=ATOL)
    full_h, _ = model({"tokens": toks})
    full = model.unembed(full_h[:, -1:])
    if S == 64:
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=ATOL)
    else:
        assert (got - full).abs().max().item() > 1e-2


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_serve_launcher_takes_the_moe_archs_on_cpu(arch):
    """``launch/serve.py --arch <MoE arch> --smoke --device cpu`` serves
    every request, a decode crash replayed included."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
           "--device", "cpu", "--batch", "2", "--prompt-len", "16", "--new-tokens", "4",
           "--inject-rate", "0.3", "--seed", "1"]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout)
    assert rep["arch"] == f"{arch}-smoke" and rep["requests"] == 2 and rep["tokens"] == 8
