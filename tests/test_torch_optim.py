"""The optimizer and gradient compression: repro_torch against the JAX
package on identical params and gradients (made with numpy from a seed),
then the reference's own property tests (tests/test_optim.py) on the port.

Tolerance: 1e-6 relative on params and moments after AdamW and 8-bit AdamW
steps (the same f32 arithmetic in two frameworks; pow and cos may differ by
an ulp).  Compression: the int8 codes are equal, so the dequantized values
agree to float rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.optim import adamw as jadamw
from repro.parallel import compression as jcomp
from repro_torch.optim import adamw
from repro_torch.parallel import compression

RTOL = 1e-6


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((64, 256)) * 0.1).astype(np.float32),
            "b": np.zeros((8,), np.float32),
            "s": (rng.standard_normal((3, 96)) * 0.1).astype(np.float32)}


def _np_grads(params, i):
    return {k: (np.cos(p + i * 0.1) * 0.05).astype(np.float32) for k, p in params.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=rtol * float(np.abs(np.asarray(b)).max() + 1e-30))


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e-3])
def test_adamw_steps_match_jax(clip):
    """Three AdamW steps (warmup into decay, with and without clipping) on
    identical gradients."""
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=clip)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    p = _np_params()
    jp, tp = _jax(p), _torch(p)
    js, ts = jadamw.init(jp), adamw.init(tp)
    for i in range(3):
        g = _np_grads(p, i)
        jp, js, jm = jadamw.apply(jcfg, jp, js, _jax(g))
        tp, ts, tm = adamw.apply(tcfg, tp, ts, _torch(g))
        for k in p:
            _close(tp[k].numpy(), jp[k])
            _close(ts.m[k].numpy(), js.m[k])
            _close(ts.v[k].numpy(), js.v[k])
        _close(float(tm["lr"]), float(jm["lr"]))
        _close(float(tm["grad_norm"]), float(jm["grad_norm"]))
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32


@pytest.mark.parametrize("clip", [1.0, 1e-3])
def test_donated_adamw_updates_in_place_to_the_same_bits(clip):
    """``donate=True`` (the trainer's step) writes each leaf's update into
    the params' and moments' own storage, by the same operations in the same
    order: three steps equal the functional update's bits, an f32 and a bf16
    leaf alike, and no new tensor is returned."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=clip)
    p = _torch(_np_params())
    p["h"] = p["w"][:, :32].to(torch.bfloat16)
    fp, fs = dict(p), adamw.init(p)
    dp, ds = {k: v.clone() for k, v in p.items()}, adamw.init(p)
    for i in range(3):
        g = {k: torch.cos(v.float() + i * 0.1) * 0.05 for k, v in fp.items()}
        fp, fs, fm = adamw.apply(cfg, fp, fs, g)
        ptrs = [t.data_ptr() for t in (*dp.values(), *ds.m.values(), *ds.v.values())]
        dp, ds, dm = adamw.apply(cfg, dp, ds, g, donate=True)
        assert [t.data_ptr() for t in (*dp.values(), *ds.m.values(), *ds.v.values())] == ptrs
        for k in p:
            for a, b in ((fp[k], dp[k]), (fs.m[k], ds.m[k]), (fs.v[k], ds.v[k])):
                assert a.dtype == b.dtype and torch.equal(a, b), k
        assert torch.equal(fm["grad_norm"], dm["grad_norm"]) and int(ds.step) == i + 1


def test_adamw_8bit_step_matches_jax():
    cfg_kw = dict(lr=1e-2, warmup_steps=1, total_steps=50)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    p = _np_params()
    jp, tp = _jax(p), _torch(p)
    js, ts = jadamw.init_8bit(jp), adamw.init_8bit(tp)
    for i in range(2):
        g = _np_grads(p, i)
        jp, js, _ = jadamw.apply_8bit(jcfg, jp, js, _jax(g))
        tp, ts, _ = adamw.apply_8bit(tcfg, tp, ts, _torch(g))
    for k in p:
        _close(tp[k].numpy(), jp[k])
    # the quantized moments: identical codes, scales to rounding
    assert ts.m["w"]["q"].dtype == torch.int8
    for mom_t, mom_j in ((ts.m, js.m), (ts.v, js.v)):
        np.testing.assert_array_equal(mom_t["w"]["q"].numpy(), np.asarray(mom_j["w"]["q"]))
        _close(mom_t["w"]["s"].numpy(), mom_j["w"]["s"])
        _close(mom_t["b"].numpy(), mom_j["b"])


@pytest.mark.parametrize("shape", [(64, 256), (1000,), (3, 7), (2, 300, 5)])
def test_compress_tree_int8_matches_jax(shape):
    rng = np.random.default_rng(3)
    g = {"g": (rng.standard_normal(shape) * 0.02).astype(np.float32)}
    want = jcomp.compress_tree(_jax(g), method="int8")["g"]
    got = compression.compress_tree(_torch(g), method="int8")["g"]
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
    if np.prod(shape) < compression.BLOCK:
        assert np.array_equal(got.numpy(), g["g"])  # tiny leaves pass through
    assert compression.compress_tree(_torch(g), method=None)["g"] is not None
    with pytest.raises(ValueError):
        compression.compress_tree(_torch(g), method="fp4")


# -- the reference's property tests (tests/test_optim.py) on the port --------
def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((64, 256), generator=g) * 0.1, "b": torch.zeros((8,))}


def test_schedule_warmup_and_decay():
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lr = {s: float(adamw.schedule(cfg, torch.tensor(s))) for s in (5, 10, 100)}
    assert lr[5] == pytest.approx(0.5e-3, rel=0.01)
    assert lr[10] == pytest.approx(1e-3, rel=0.01)
    assert lr[100] == pytest.approx(0.1e-3, rel=0.05)


def test_grad_clipping_bounds_update():
    cfg = adamw.AdamWConfig(lr=1e-2, grad_clip=1.0, warmup_steps=0)
    p = _params()
    huge = {k: torch.ones_like(x) * 1e6 for k, x in p.items()}
    new, _, m = adamw.apply(cfg, p, adamw.init(p), huge)
    assert float(m["grad_norm"]) > 1e5  # norm reported pre-clip
    assert max(float((new[k] - p[k]).abs().max()) for k in p) < 0.1


@given(st.integers(0, 3))
def test_adamw_decreases_quadratic(seed):
    cfg = adamw.AdamWConfig(lr=5e-2, warmup_steps=0, weight_decay=0.0)
    p = _params(seed)
    s = adamw.init(p)

    def loss(p):
        return sum(torch.sum(torch.square(x)) for x in p.values())

    l0 = float(loss(p))
    for _ in range(20):
        p, s, _ = adamw.apply(cfg, p, s, {k: 2.0 * x for k, x in p.items()})
    assert float(loss(p)) < 0.5 * l0


def test_8bit_matches_f32_trajectory():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=50)
    p32 = p8 = _params()
    s32, s8 = adamw.init(p32), adamw.init_8bit(p8)
    for i in range(10):
        p32, s32, _ = adamw.apply(cfg, p32, s32,
                                  {k: torch.cos(p + i * 0.1) * 0.05 for k, p in p32.items()})
        p8, s8, _ = adamw.apply_8bit(cfg, p8, s8,
                                     {k: torch.cos(p + i * 0.1) * 0.05 for k, p in p8.items()})
    drift = float((p32["w"] - p8["w"]).abs().max())
    update = float((p32["w"] - _params()["w"]).abs().max())
    assert drift < 0.25 * update  # quantization noise << signal


def test_8bit_state_is_actually_small():
    s8 = adamw.init_8bit(_params())
    m_w = s8.m["w"]
    assert isinstance(m_w, dict) and m_w["q"].dtype == torch.int8
    assert m_w["s"].numel() == m_w["q"].numel() // 256
    assert s8.m["b"].dtype == torch.float32  # tiny leaves stay f32


def test_8bit_quant_roundtrip_bounded():
    x = torch.randn((16, 512), generator=torch.Generator().manual_seed(0)) * 0.01
    back = adamw._dq8(adamw._q8(x))
    scale = float(x.abs().max()) / 127.0
    assert float((back - x).abs().max()) <= scale * 0.51 + 1e-9


def test_opt_block_divides():
    for d in (128, 256, 3072, 151936, 24576, 1187):
        b = adamw._opt_block(d)
        assert d % b == 0 and b <= 256 and b == jadamw._opt_block(d)
