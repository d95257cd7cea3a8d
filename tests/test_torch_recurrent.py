"""repro_torch's recurrent blocks against repro.models.recurrent on the same
weights and inputs (numpy, seeded), f32: the RWKV-6 block at smoke rwkv6-7b
width and the RG-LRU block at smoke recurrentgemma-9b width.

The reference init leaves some paths at zero (rwkv's LoRA, tm_lora_B and
wd_B; rglru's gate biases), so the weights here are drawn for every
parameter, zeros included.  Tolerance 1e-5:
the same f32 arithmetic summed in a different order by two frameworks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke
from repro.models import recurrent as jrec
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.models import recurrent as trec

ATOL = 1e-5


def _pair():
    jcfg, tcfg = jsmoke(jget_arch("rwkv6-7b")), smoke_config(get_arch("rwkv6-7b"))
    assert (jcfg.d_model, jcfg.d_ff, jcfg.norm_eps) == (tcfg.d_model, tcfg.d_ff, tcfg.norm_eps)
    assert (tcfg.rwkv.head_dim, tcfg.rwkv.ddlerp_rank, tcfg.rwkv.decay_rank) == (
        jcfg.rwkv.head_dim, jcfg.rwkv.ddlerp_rank, jcfg.rwkv.decay_rank)
    return jcfg, tcfg


def _weights(tcfg, rng):
    """numpy weights for every rwkv parameter, none of them zero: the
    reference's std for "normal" defs, small noise around the rest."""
    out = {}
    for name, d in trec.rwkv_defs(tcfg).items():
        x = rng.standard_normal(d.shape).astype(np.float32)
        if d.init == "ones":
            out[name] = 1.0 + 0.1 * x
        elif d.init == "custom":  # decay logits around the init's span
            out[name] = np.linspace(-6.0, -0.5, d.shape[-1], dtype=np.float32) + 0.3 * x
        elif d.init == "zeros":
            out[name] = 0.1 * x
        else:
            out[name] = x * d.init_scale / np.sqrt(np.prod(d.shape[:-1]))
    return out


@pytest.mark.parametrize("S,with_state", [(16, False), (1, True)])
def test_rwkv_block_matches_jax(S, with_state):
    jcfg, tcfg = _pair()
    rng = np.random.default_rng(S)
    p = _weights(tcfg, rng)
    assert set(p) == set(jrec.rwkv_defs(jcfg))
    B, d = 2, tcfg.d_model
    H, Dh = trec.rwkv_heads(tcfg)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    st = None
    if with_state:
        st = {"S": rng.standard_normal((B, H, Dh, Dh)).astype(np.float32) * 0.3,
              "ts1": rng.standard_normal((B, d)).astype(np.float32),
              "ts2": rng.standard_normal((B, d)).astype(np.float32)}
    want, wst = jrec.rwkv_block({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                jcfg, None if st is None else
                                {k: jnp.asarray(v) for k, v in st.items()})
    tst = None if st is None else {k: torch.tensor(v) for k, v in st.items()}
    got, gst = trec.rwkv_block({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x),
                               tcfg, tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert set(gst) == set(wst) == {"S", "ts1", "ts2"}
    for name in gst:
        assert gst[name].dtype == torch.float32
        np.testing.assert_allclose(gst[name].numpy(), np.asarray(wst[name]), atol=ATOL)
    if tst is not None:  # the given state is updated in place
        assert all(gst[k] is tst[k] for k in tst)


def test_rwkv_init_state_matches_jax():
    jcfg, tcfg = _pair()
    want = jrec.rwkv_init_state(jcfg, 3)
    got = trec.rwkv_init_state(tcfg, 3)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 and not v.any() for v in got.values())


# -- RG-LRU (recurrentgemma-9b at smoke width) ---------------------------------
def _rg_pair():
    jcfg, tcfg = jsmoke(jget_arch("recurrentgemma-9b")), smoke_config(get_arch("recurrentgemma-9b"))
    assert (jcfg.d_model, jcfg.d_ff, jcfg.norm_eps) == (tcfg.d_model, tcfg.d_ff, tcfg.norm_eps)
    assert (jcfg.rglru.lru_width, jcfg.rglru.n_heads, jcfg.rglru.conv_width) == (
        tcfg.rglru.lru_width, tcfg.rglru.n_heads, tcfg.rglru.conv_width)
    return jcfg, tcfg


def _flat_defs(defs, prefix=""):
    for k, d in defs.items():
        if isinstance(d, dict):
            yield from _flat_defs(d, f"{prefix}{k}/")
        else:
            yield prefix + k, d


def _rg_weights(tcfg, rng):
    """numpy weights for every rglru parameter (the ffn subtree included),
    none of them zero: the reference's std for "normal" defs, noise around
    1 for norms, small noise for the zero-init gate biases, and lam around
    its init's span."""
    out = {}
    for name, d in _flat_defs(trec.rglru_defs(tcfg)):
        x = rng.standard_normal(d.shape).astype(np.float32)
        if d.init == "ones":
            out[name] = 1.0 + 0.1 * x
        elif d.init == "custom":  # lam: decays a in about (0.9, 0.999)
            a = rng.uniform(0.9, 0.999, d.shape)
            out[name] = np.log(np.expm1(-np.log(a) / 8.0)).astype(np.float32)
        elif d.init == "zeros":
            out[name] = 0.1 * x
        else:
            out[name] = x * d.init_scale / np.sqrt(np.prod(d.shape[:-1]))
    return out


def _nest(flat, lib):
    out = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = lib(v)
    return out


def _rg_state(tcfg, B, rng):
    W, K = tcfg.rglru.lru_width, tcfg.rglru.conv_width
    return {"h": rng.standard_normal((B, W)).astype(np.float32),
            "conv": rng.standard_normal((B, K - 1, W)).astype(np.float32)}


@pytest.mark.parametrize("S,with_state", [(16, False), (1, True)])
def test_rglru_block_matches_jax(S, with_state):
    jcfg, tcfg = _rg_pair()
    rng = np.random.default_rng(10 + S)
    p = _rg_weights(tcfg, rng)
    assert set(p) == set(dict(_flat_defs(jrec.rglru_defs(jcfg))))
    B = 2
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    st = _rg_state(tcfg, B, rng) if with_state else None
    want, wst = jrec.rglru_block(_nest(p, jnp.asarray), jnp.asarray(x), jcfg,
                                 None if st is None else
                                 {k: jnp.asarray(v) for k, v in st.items()})
    tst = None if st is None else {k: torch.tensor(v) for k, v in st.items()}
    got, gst = trec.rglru_block(_nest(p, torch.tensor), torch.tensor(x), tcfg, tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert set(gst) == set(wst) == {"h", "conv"}
    for name in gst:
        assert gst[name].dtype == torch.float32
        np.testing.assert_allclose(gst[name].numpy(), np.asarray(wst[name]), atol=ATOL)
    if tst is not None:  # the given state is updated in place
        assert all(gst[k] is tst[k] for k in tst)


def test_rglru_block_state_continuity():
    """A prefill of S tokens, then n single steps with the carried state,
    equals one pass over S + n tokens."""
    _, tcfg = _rg_pair()
    rng = np.random.default_rng(20)
    p = _nest(_rg_weights(tcfg, rng), torch.tensor)
    S, n = 12, 5
    x = torch.tensor(rng.standard_normal((2, S + n, tcfg.d_model)).astype(np.float32))
    full, fst = trec.rglru_block(p, x, tcfg)
    out, st = trec.rglru_block(p, x[:, :S], tcfg)
    steps = [out]
    for t in range(S, S + n):
        o, st2 = trec.rglru_block(p, x[:, t:t + 1], tcfg, st)
        assert st2 is st
        steps.append(o)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=ATOL)
    for name in st:
        np.testing.assert_allclose(st[name].numpy(), fst[name].numpy(), atol=ATOL)


def test_rglru_init_state_matches_jax():
    jcfg, tcfg = _rg_pair()
    want = jrec.rglru_init_state(jcfg, 3)
    got = trec.rglru_init_state(tcfg, 3)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 and not v.any() for v in got.values())
    stacked = trec.rglru_init_state(tcfg, 3, stack=2)
    assert {k: tuple(v.shape) for k, v in stacked.items()} == {
        k: (2,) + tuple(v.shape) for k, v in want.items()}
