"""repro_torch dense layers against repro.models.layers on the same weights
and inputs (numpy, seeded), f32.  Tolerance 1e-5: the same f32 arithmetic
summed in a different order by two frameworks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke
from repro.models import layers as jl
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.models import layers as tl

ATOL = 1e-5


def _pair(arch):
    """The same smoke config from both packages."""
    jcfg, tcfg = jsmoke(jget_arch(arch)), smoke_config(get_arch(arch))
    assert (jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.d_head, jcfg.d_ff,
            jcfg.qk_norm, jcfg.rope_theta) == (
        tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.d_head, tcfg.d_ff,
        tcfg.qk_norm, tcfg.rope_theta)
    return jcfg, tcfg


def _weights(defs, rng, scale=0.2):
    """numpy weights for a dict of ParamDefs (either package's)."""
    return {k: (rng.standard_normal(d.shape).astype(np.float32) * scale
                if d.init == "normal" else
                1.0 + 0.1 * rng.standard_normal(d.shape).astype(np.float32))
            for k, d in defs.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32)
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    pos = np.arange(40) + 5
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    # positions up to 45 rad: f32 sin/cos of two libraries differ by ~1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("gated", [True, False])
def test_ffn_matches(gated):
    jcfg, tcfg = _pair("rsc-llm")
    jcfg, tcfg = (dataclasses.replace(c, ffn_gated=gated) for c in (jcfg, tcfg))
    rng = np.random.default_rng(2)
    p = _weights(tl.ffn_defs(tcfg), rng)
    assert set(p) == set(jl.ffn_defs(jcfg))
    x = rng.standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    got = tl.ffn(_t(p), torch.from_numpy(x))
    want = jl.ffn(_j(p), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", ["rsc-llm", "qwen3-0.6b"])
def test_self_attention_matches(arch):
    jcfg, tcfg = _pair(arch)
    rng = np.random.default_rng(3)
    p = _weights(tl.attention_defs(tcfg), rng)
    assert set(p) == set(jl.attention_defs(jcfg))
    S = 24
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    pos = np.arange(S)
    got, (gk, gv) = tl.self_attention(_t(p), torch.from_numpy(x), tcfg, "global",
                                      positions=torch.from_numpy(pos))
    want, (wk, wv) = jax.jit(jl.self_attention, static_argnums=(2, 3))(
        _j(p), jnp.asarray(x), jcfg, "global", positions=jnp.asarray(pos))
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_decode_self_attention_matches_and_updates_ring_slot():
    jcfg, tcfg = _pair("rsc-llm")
    rng = np.random.default_rng(4)
    p = _weights(tl.attention_defs(tcfg), rng)
    B, L = 2, 12
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, L, tcfg.n_kv_heads, tcfg.d_head)).astype(np.float32)
    vc = rng.standard_normal((B, L, tcfg.n_kv_heads, tcfg.d_head)).astype(np.float32)
    for pos in (7, L, L + 5):  # inside the cache, and wrapped onto the ring
        got, gk, gv = tl.decode_self_attention(
            _t(p), torch.from_numpy(x), tcfg, "global",
            torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), pos)
        want, wk, wv = jax.jit(jl.decode_self_attention, static_argnums=(2, 3))(
            _j(p), jnp.asarray(x), jcfg, "global", jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(pos, jnp.int32))
        for a, b in ((got, want), (gk, wk), (gv, wv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
        assert not np.allclose(gk[:, pos % L].numpy(), kc[:, pos % L])


def test_unported_kinds_raise():
    """Every attention kind is ported (chunked too); a kind that is not an
    attention kind raises rather than attending unmasked."""
    _, tcfg = _pair("rsc-llm")
    x = torch.zeros((1, 4, tcfg.d_model))
    p = _t(_weights(tl.attention_defs(tcfg), np.random.default_rng(5)))
    for kind in ("rglru", "rwkv"):
        with pytest.raises(ValueError, match=kind):
            tl.self_attention(p, x, tcfg, kind)
    out, _ = tl.self_attention(p, x, tcfg, "chunked")
    assert out.shape == x.shape


# -- chunked attention: smoke llama4-scout-17b-a16e, chunk (its window) 16 --
@pytest.mark.parametrize("S", [40, 48])
def test_chunked_self_attention_matches(S):
    jcfg, tcfg = _pair("llama4-scout-17b-a16e")
    jcfg, tcfg = (dataclasses.replace(c, window=16) for c in (jcfg, tcfg))
    rng = np.random.default_rng(9)
    p = _weights(tl.attention_defs(tcfg), rng)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    pos = np.arange(S)
    got, (gk, gv) = tl.self_attention(_t(p), torch.from_numpy(x), tcfg, "chunked",
                                      positions=torch.from_numpy(pos))
    want, (wk, wv) = jax.jit(jl.self_attention, static_argnums=(2, 3))(
        _j(p), jnp.asarray(x), jcfg, "chunked", positions=jnp.asarray(pos))
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    glob, _ = tl.self_attention(_t(p), torch.from_numpy(x), tcfg, "global",
                                positions=torch.from_numpy(pos))
    np.testing.assert_allclose(glob.numpy()[:, :16], got.numpy()[:, :16], atol=ATOL)
    assert not np.allclose(glob.numpy()[:, 16:], got.numpy()[:, 16:], atol=1e-3)


@pytest.mark.parametrize("pos", [10, 15, 16, 21, 47])
def test_chunked_decode_matches_on_the_ring(pos):
    """A chunk-long ring: within the first chunk, at a chunk's first
    position (it attends to itself alone), and wrapped."""
    jcfg, tcfg = _pair("llama4-scout-17b-a16e")
    jcfg, tcfg = (dataclasses.replace(c, window=16) for c in (jcfg, tcfg))
    rng = np.random.default_rng(10)
    p = _weights(tl.attention_defs(tcfg), rng)
    B, L = 2, tcfg.kv_cache_len("chunked", 10_000)
    assert L == 16
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, L, tcfg.n_kv_heads, tcfg.d_head)).astype(np.float32)
    vc = rng.standard_normal((B, L, tcfg.n_kv_heads, tcfg.d_head)).astype(np.float32)
    got, gk, gv = tl.decode_self_attention(
        _t(p), torch.from_numpy(x), tcfg, "chunked",
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), pos)
    want, wk, wv = jax.jit(jl.decode_self_attention, static_argnums=(2, 3))(
        _j(p), jnp.asarray(x), jcfg, "chunked", jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos, jnp.int32))
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


# -- local (sliding-window) attention: smoke recurrentgemma-9b, MQA, window 64 --
def test_local_self_attention_matches():
    jcfg, tcfg = _pair("recurrentgemma-9b")
    assert jcfg.window == tcfg.window == 64 and tcfg.n_kv_heads == 1
    rng = np.random.default_rng(6)
    p = _weights(tl.attention_defs(tcfg), rng)
    S = 100  # past the window, so the mask cuts
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    pos = np.arange(S)
    got, (gk, gv) = tl.self_attention(_t(p), torch.from_numpy(x), tcfg, "local",
                                      positions=torch.from_numpy(pos))
    want, (wk, wv) = jax.jit(jl.self_attention, static_argnums=(2, 3))(
        _j(p), jnp.asarray(x), jcfg, "local", positions=jnp.asarray(pos))
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    glob, _ = tl.self_attention(_t(p), torch.from_numpy(x), tcfg, "global",
                                positions=torch.from_numpy(pos))
    assert not np.allclose(glob.numpy()[:, 64:], got.numpy()[:, 64:], atol=1e-3)
    np.testing.assert_allclose(glob.numpy()[:, :64], got.numpy()[:, :64], atol=ATOL)


@pytest.mark.parametrize("pos", [10, 63, 64, 80, 150])
def test_local_decode_matches_on_the_ring(pos):
    """A window-long ring cache: before it fills (slots past pos are empty),
    at the first wrap, and wrapped more than once."""
    jcfg, tcfg = _pair("recurrentgemma-9b")
    rng = np.random.default_rng(7)
    p = _weights(tl.attention_defs(tcfg), rng)
    B, L = 2, tcfg.kv_cache_len("local", 10_000)
    assert L == 64
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, L, 1, tcfg.d_head)).astype(np.float32)
    vc = rng.standard_normal((B, L, 1, tcfg.d_head)).astype(np.float32)
    got, gk, gv = tl.decode_self_attention(
        _t(p), torch.from_numpy(x), tcfg, "local",
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), pos)
    want, wk, wv = jax.jit(jl.decode_self_attention, static_argnums=(2, 3))(
        _j(p), jnp.asarray(x), jcfg, "local", jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos, jnp.int32))
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    assert not np.allclose(gk[:, pos % L].numpy(), kc[:, pos % L])
    # before the ring fills, the slots past pos are empty: what they hold
    # does not change the output
    if pos < L - 1:
        kc2 = kc.copy()
        kc2[:, pos + 1:] += 5.0
        other, _, _ = tl.decode_self_attention(
            _t(p), torch.from_numpy(x), tcfg, "local",
            torch.from_numpy(kc2), torch.from_numpy(vc.copy()), pos)
        np.testing.assert_allclose(other.numpy(), got.numpy(), atol=ATOL)


def test_flash_attention_d256_mqa_window_matches_jax_ref():
    """The recurrentgemma-9b head shape (d_head 256, one kv head) with a
    window, f32, on the CPU path of ops.flash_attention."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ops as tops

    rng = np.random.default_rng(8)
    B, S, H, D, window = 2, 96, 4, 256, 32
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, 1, D)).astype(np.float32)
    v = rng.standard_normal((B, S, 1, D)).astype(np.float32)
    got = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=True, window=window)
    want = jref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
