"""The roofline's inputs against the JAX package's: ``active_param_count``
for all eleven architectures, ``model_flops`` for every (arch x shape),
``roofline.analyze`` over the same figures; and the kernels' closed-form
work (``kernels.cost``) against a count from the full Sq x Sk mask at small
shapes, every (causal, window, chunk, q_offset) and Sq != Sk."""
import itertools

import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import list_archs
from repro.launch import hw as jhw
from repro.launch import roofline as jroofline
from repro_torch.configs.base import SHAPES, get_arch
from repro_torch.kernels import cost
from repro_torch.launch import hw, roofline


def test_shapes_are_the_reference_shapes():
    assert {k: vars(v) for k, v in SHAPES.items()} == {k: vars(v) for k, v in JSHAPES.items()}
    assert all(SHAPES[k].tokens == JSHAPES[k].tokens for k in SHAPES)


@pytest.mark.parametrize("arch", list_archs())
def test_active_params_and_model_flops_match_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.ffn_active_params() == jcfg.ffn_active_params()
    assert cfg.active_param_count() <= cfg.param_count()
    for name in SHAPES:
        assert roofline.model_flops(cfg, SHAPES[name]) == jroofline.model_flops(jcfg, JSHAPES[name])


@pytest.mark.parametrize("terms", [(1e15, 1e12, 0.0, 0.0), (1e12, 1e13, 0.0, 0.0),
                                   (1e12, 1e9, 1e12, 1e11)])
def test_analyze_is_the_reference_formula_over_the_h100(monkeypatch, terms):
    """With the reference's figures set to the H100's, both packages give the
    same roofline; the collective term reads NVLink within a node and
    InfiniBand across."""
    for name, value in (("PEAK_FLOPS_BF16", hw.PEAK_FLOPS_BF16), ("HBM_BW", hw.HBM_BW),
                        ("ICI_BW", hw.NVLINK_BW), ("DCN_BW", hw.IB_BW)):
        monkeypatch.setattr(jhw, name, value)
    flops, nbytes, intra, cross = terms
    kw = dict(n_devices=256, flops_per_device=flops, bytes_per_device=nbytes,
              intra_pod_coll_bytes=intra, cross_pod_coll_bytes=cross)
    got = roofline.analyze(get_arch("granite-20b"), SHAPES["train_4k"], **kw).to_dict()
    want = jroofline.analyze(jget_arch("granite-20b"), JSHAPES["train_4k"], **kw).to_dict()
    want["trace_flops_device"] = want.pop("hlo_flops_device")
    assert got == pytest.approx(want) and got["dominant"] == want["dominant"]
    assert got["collective_s"] == pytest.approx(intra / 450e9 + cross / 50e9)


def test_hw_is_the_h100_data_sheet():
    assert hw.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert hw.HBM_BW == 3.35e12 and hw.HBM_BYTES == 80 * 10**9
    assert (hw.NVLINK_BW, hw.IB_BW, hw.CHIPS_PER_POD) == (450e9, 50e9, 8)
    ms, by = hw.bound_ms(989e9, 1.0)
    assert ms == pytest.approx(1.0) and by == "operations"
    assert hw.bound_ms(1.0, 3.35e9, "float32") == (pytest.approx(1.0), "bytes")


def _mask_pairs(Sq, Sk, causal, window, chunk, q_offset):
    qp = q_offset + torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    m = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        m &= qp >= kp
    if window:
        m &= (qp - kp) < window
    if chunk:
        m &= (qp // chunk) == (kp // chunk)
    return int(m.sum())


MASKS = list(itertools.product((True, False), (0, 5, 64), (0, 7, 32)))
SIZES = [(37, 37, 0), (16, 90, 0), (90, 16, 0), (24, 100, 60), (50, 50, 13), (1, 300, 299),
         (33, 40, 200)]


@pytest.mark.parametrize("causal,window,chunk", MASKS)
def test_attended_pairs_equal_the_mask(causal, window, chunk):
    for Sq, Sk, off in SIZES:
        want = _mask_pairs(Sq, Sk, causal, window, chunk, off)
        got = cost.attended_pairs(Sq, Sk, causal=causal, window=window, chunk=chunk,
                                  q_offset=off)
        assert got == want, (Sq, Sk, off)


def test_kernel_work_formulas():
    """The forms chip_smoke.py's bounds take (and the fake route adds)."""
    B, S, H, KV, D = 2, 64, 4, 2, 32
    pairs = _mask_pairs(S, S, True, 0, 0, 0)
    assert cost.flash_fwd(B, S, S, H, KV, D, 2, causal=True) == (
        4.0 * B * H * D * pairs, float((2 * B * S * H * D + 2 * B * S * KV * D) * 2))
    f, b = cost.flash_fwd(B, S, S, H, KV, D, 2, causal=True, with_lse=True)
    assert b == (2 * B * S * H * D + 2 * B * S * KV * D) * 2 + B * H * S * 4
    assert cost.flash_bwd(B, S, S, H, KV, D, 4, causal=True) == (
        10.0 * B * H * D * pairs, float((4 * B * S * H * D + 4 * B * S * KV * D) * 4 + B * H * S * 4))
    assert cost.wkv6_fwd(B, S, H, D, 2) == (
        5.0 * B * S * H * D * D, float(5 * B * S * H * D * 2 + H * D * 2 + 2 * B * H * D * D * 4))
    assert cost.wkv6_bwd(B, S, H, D, 2, with_state=True)[1] == (
        9 * B * S * H * D * 2 + H * D * 6 + 3 * B * H * D * D * 4)
    assert cost.rglru_fwd(B, S, 128, 2, 4) == (9.0 * B * S * 128, float(B * S * 128 * 8 + 2 * B * 128 * 4))
    assert cost.rglru_bwd(B, S, 128, 2, 4) == (30.0 * B * S * 128,
                                               float(B * S * 128 * 14 + 3 * B * 128 * 4))


def test_fake_route_adds_the_work_and_real_calls_do_not():
    """A FakeTensor takes each wrapper's fake route: outputs of the
    kernel's shapes and dtypes, its work in ``cost.fake``; a real CPU call
    takes the plain version and adds nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru as kg
    from repro_torch.kernels import wkv6 as k6

    B, S, H, KV, D = 2, 48, 4, 2, 16
    cost.reset()
    q, k = torch.randn(B, S, H, D), torch.randn(B, S, KV, D)
    fa.flash_attention(q, k, k)
    k6.wkv6(q, q, q, torch.rand(B, S, H, D), torch.randn(H, D))
    assert cost.fake == {"flops": 0.0, "bytes": 0.0, "calls": {}}
    with FakeTensorMode():
        q, k = torch.empty(B, S, H, D, dtype=torch.bfloat16), torch.empty(B, S, KV, D,
                                                                          dtype=torch.bfloat16)
        o, lse = fa.flash_attention_lse(q, k, k, window=8)
        assert (o.shape, o.dtype, lse.shape, lse.dtype) == (q.shape, q.dtype, (B, H, S),
                                                            torch.float32)
        dq, dk, dv = fa.flash_attention_bwd(q, k, k, o, lse, o, window=8)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
        state = torch.empty(B, H, D, D)
        out, s = k6.wkv6(q, q, q, q, torch.empty(H, D), state)
        assert s is state and out.shape == q.shape
        grads = k6.wkv6_bwd(q, q, q, q, torch.empty(H, D), None, q)
        assert [g.shape for g in grads] == [q.shape] * 4 + [(H, D), (B, H, D, D)]
        x, la = torch.empty(B, S, 64, dtype=torch.bfloat16), torch.empty(B, S, 64)
        h, hl = kg.rglru(x, la)
        assert (h.shape, h.dtype, hl.shape, hl.dtype) == (x.shape, x.dtype, (B, 64), torch.float32)
        dx, dla, dh0 = kg.rglru_bwd(x, la, None, x)
        assert (dx.dtype, dla.dtype, dh0.shape) == (x.dtype, la.dtype, (B, 64))
    want = [cost.flash_fwd(B, S, S, H, KV, D, 2, causal=True, window=8, with_lse=True),
            cost.flash_bwd(B, S, S, H, KV, D, 2, causal=True, window=8),
            cost.wkv6_fwd(B, S, H, D, 2), cost.wkv6_bwd(B, S, H, D, 2),
            cost.rglru_fwd(B, S, 64, 2, 4), cost.rglru_bwd(B, S, 64, 2, 4)]
    assert cost.fake["flops"] == sum(w[0] for w in want)
    assert cost.fake["bytes"] == sum(w[1] for w in want)
    assert cost.fake["calls"] == {"flash_attention_fwd_lse": 1, "flash_attention_bwd": 1,
                                  "wkv6_fwd": 1, "wkv6_bwd": 1, "rglru_fwd": 1, "rglru_bwd": 1}
    cost.reset()
