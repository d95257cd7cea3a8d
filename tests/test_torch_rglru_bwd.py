"""repro_torch's RG-LRU backward against the JAX package: the plain version
(``ref.rglru_bwd_ref``) and the autograd Function ``RGLRU`` on CPU tensors
vs ``jax.vjp`` of ``repro.kernels.ref.rglru_ref`` (the sequential oracle)
and of ``repro.kernels.ops.rglru`` through its associative scan
(``REPRO_USE_PALLAS=0``, the form the reference trains through: its Pallas
kernel has no backward), with respect to x, log_a and h0, with cotangents on
the output and the final state.

Inputs come from numpy with a seed: the reference test's distribution
(x ~ N(0, 1), log_a = -softplus(N(0, 1)), h0 ~ N(0, 1)), and log_a set to
exactly 0 (the clamp wins: its gradient share is 0), to -1e-7 (1 - a^2
rounds to a few ulps: d sqrt / d log_a is large) and to -30 and -200 (a
underflows toward and to 0) on some steps.  Tolerances: 1e-5 max(1, |want|)
against the sequential oracle (the same f32 arithmetic in the same order,
two libraries' exp); 1e-4 max(1, |want|) against the associative scan (the
reference's own tolerance between its two forms, tests/test_kernels.py;
scaled, since dlog_a reaches 3e4 near log_a = 0, where one f32 ulp is
2e-3).  For dlog_a the scale also takes |x ds/dlog_a| (= |x| e / s where
the clamp does not win): dlog_a_t = g_t (h_{t-1} a_t + x_t ds_t/dlog_a_t),
and near log_a = 0 that factor reaches 2e3 |x|, so an exp one ulp apart in
the two libraries moves g_t by an ulp and dlog_a by 2e3 ulps of g_t, also
where g_t (a sum of terms of either sign) and so dlog_a come out small."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru as kg

SHAPES = [(1, 1, 8), (2, 33, 16), (1, 128, 64), (2, 70, 40)]
MODES = ("ref", "zero", "near0", "underflow")
NAMES = ("dx", "dlog_a", "dh0")


def _inputs(B, S, W, mode, seed=0):
    """x, log_a, h0 and the cotangents do and dh, as numpy f32."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = n(B, S, W)
    la = -np.logaddexp(n(B, S, W), 0.0).astype(np.float32)
    if mode == "zero":
        la[:, ::3] = 0.0
    elif mode == "near0":
        la[:, ::2] = -1e-7
    elif mode == "underflow":
        la[:, ::2] = -30.0
        la[:, 1::4] = -200.0
    return [x, la, n(B, W), n(B, S, W), n(B, W)]


@functools.lru_cache(maxsize=None)
def _want(shape, mode, with_h0, oracle):
    """(out, final h) and the three cotangents from jax.vjp, as numpy; h0 is
    zeros when the case has none."""
    x, la, h0, do, dh = (jnp.asarray(a) for a in _inputs(*shape, mode))
    if not with_h0:
        h0 = jnp.zeros_like(h0)
    fn = jref.rglru_ref if oracle == "sequential" else jops.rglru
    (out, h), vjp = jax.vjp(jax.jit(fn), x, la, h0)
    return tuple(np.asarray(a) for a in (out, h) + tuple(vjp((do, dh))))


@pytest.fixture(autouse=True)
def _scan_form():
    """jops.rglru takes the associative scan (read at each call)."""
    old = os.environ.get("REPRO_USE_PALLAS")
    os.environ["REPRO_USE_PALLAS"] = "0"
    yield
    if old is None:
        os.environ.pop("REPRO_USE_PALLAS")
    else:
        os.environ["REPRO_USE_PALLAS"] = old


def _torch(shape, mode, with_h0):
    x, la, h0, do, dh = (torch.from_numpy(a) for a in _inputs(*shape, mode))
    return x, la, (h0 if with_h0 else None), do, dh


def _dl_scale(shape, mode):
    """|x ds/dlog_a| of each element (f64): |x| e / s where 1 - e > 1e-12,
    else 0 (the clamp wins and passes no gradient)."""
    x, la = (a.astype(np.float64) for a in _inputs(*shape, mode)[:2])
    e = np.exp(2.0 * la)
    u = 1.0 - e
    return np.where(u > 1e-12, np.abs(x) * e / np.sqrt(np.maximum(u, 1e-12)), 0.0)


def _close(got, want, name, rel, scale=0.0):
    got = got.detach().numpy()
    lim = rel * np.maximum(np.maximum(1.0, np.abs(want)), scale)
    assert np.isfinite(got).all(), name
    assert (np.abs(got - want) <= lim).all(), (name, float(np.max(np.abs(got - want) - lim)))


TOL = {"sequential": 1e-5, "scan": 1e-4}


@pytest.mark.parametrize("oracle", ["sequential", "scan"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp(shape, with_h0, mode, oracle):
    x, la, h0, do, dh = _torch(shape, mode, with_h0)
    got = ref.rglru_bwd_ref(x, la, h0, do, dh)
    assert [g.dtype for g in got] == [torch.float32] * 3
    assert got[2].shape == (shape[0], shape[2])
    scales = (0.0, _dl_scale(shape, mode), 0.0)
    for name, g, w, sc in zip(NAMES, got, _want(shape, mode, with_h0, oracle)[2:], scales):
        _close(g, w, name, TOL[oracle], sc)


@pytest.mark.parametrize("oracle", ["sequential", "scan"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", SHAPES[1:])
def test_function_gradients_match_jax_vjp(shape, with_h0, mode, oracle):
    """``ops.rglru`` under grad takes ``RGLRU``; a given h0 is updated in
    place to the final state (serving's contract), and the gradients, its
    own included, are still those of the state it was given."""
    x, la, h0, do, dh = _torch(shape, mode, with_h0)
    xl, ll = x.clone().requires_grad_(), la.clone().requires_grad_()
    h_leaf = h0.clone().requires_grad_() if with_h0 else None
    h_in = h_leaf * 1.0 if with_h0 else None  # a non-leaf, so it may be updated in place
    out, h = ops.rglru(xl, ll, h_in)
    want = _want(shape, mode, with_h0, oracle)
    assert type(out.grad_fn).__name__ == "RGLRUBackward"
    _close(out, want[0], "out", TOL[oracle])
    _close(h, want[1], "final h", TOL[oracle])
    if with_h0:
        assert h is h_in  # updated in place
    inputs = [xl, ll] + ([h_leaf] if with_h0 else [])
    grads = torch.autograd.grad((out, h), inputs, (do, dh))
    scales = (0.0, _dl_scale(shape, mode), 0.0)
    for name, g, w, sc in zip(NAMES, grads, want[2:], scales):
        _close(g, w, name, TOL[oracle], sc)
    assert h_leaf is None or torch.equal(h_leaf, h0)  # the caller's leaf is not touched


def test_extreme_log_a_gives_the_clamp_and_underflow_gradients():
    """At log_a = 0 the clamp wins (s = 1e-6, its gradient share 0): dx =
    1e-6 g and dlog_a = g h_{t-1}; at log_a = -200, a = 0 in f32: dlog_a =
    0 from the recurrence, the carry stops, and dh0 is 0."""
    x = torch.tensor([[[2.0], [3.0]]])
    do = torch.tensor([[[1.0], [0.5]]])
    h0 = torch.tensor([[0.25]])
    la = torch.zeros((1, 2, 1))
    dx, dla, dh0 = ref.rglru_bwd_ref(x, la, h0, do)
    s = float(torch.sqrt(torch.tensor(1e-12)))
    h1 = 0.25 + s * 2.0
    assert torch.allclose(dx, torch.tensor([[[1.5 * s], [0.5 * s]]]))
    assert torch.allclose(dla, torch.tensor([[[1.5 * 0.25], [0.5 * h1]]]))
    assert torch.allclose(dh0, torch.tensor([[1.5]]))
    dx, dla, dh0 = ref.rglru_bwd_ref(x, torch.full((1, 2, 1), -200.0), h0, do)
    assert torch.equal(dla, torch.zeros_like(dla)) and float(dh0) == 0.0
    assert torch.equal(dx, do)  # s = 1: g_t = dO_t, the carry a g is 0


def test_training_path_drops_the_final_state():
    """The block discards the final state, so its cotangent is zero: the
    Function's gradients equal the plain backward without ``dh``, bit for
    bit, and bf16 x with f32 log_a (the main path's types) give dx in bf16
    and dlog_a in f32."""
    x, la, h0, do, _ = _torch((2, 33, 16), "ref", True)
    xl, ll = x.clone().requires_grad_(), la.clone().requires_grad_()
    out, _ = ops.rglru(xl, ll, torch.zeros_like(h0))
    grads = torch.autograd.grad(out, (xl, ll), do)
    want = ref.rglru_bwd_ref(x, la, None, do, None)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    xb = x.bfloat16().requires_grad_()
    out, _ = ops.rglru(xb, ll, torch.zeros_like(h0))
    gx, gl = torch.autograd.grad(out, (xb, ll), do.bfloat16())
    assert gx.dtype == torch.bfloat16 and gl.dtype == torch.float32
    want = ref.rglru_bwd_ref(xb.detach(), la, None, do.bfloat16())
    assert torch.equal(gx, want[0]) and torch.equal(gl, want[1])


def test_function_marks_the_given_state_dirty():
    """The in-place update of h0 is recorded: a later use of the state's
    value before the update raises, as autograd's version check does for
    any tensor saved and then changed in place."""
    x, la, h0, do, _ = _torch((1, 8, 4), "ref", True)
    h_leaf = h0.clone().requires_grad_()
    h_in = h_leaf * 1.0
    saved = h_in * h_in  # saves h_in for its own backward
    out, h = ops.rglru(x.requires_grad_(), la, h_in)
    assert h is h_in and h._version > 0
    with pytest.raises(RuntimeError, match="modified by an inplace operation"):
        torch.autograd.grad(saved.sum(), h_leaf)


def test_serving_takes_the_forward_wrapper_alone():
    """Without grad (or with no input requiring it) ``ops.rglru`` is the
    forward wrapper: no autograd node, the state updated in place."""
    x, la, h0, _, _ = _torch((1, 8, 4), "ref", True)
    st = h0.clone()
    with torch.inference_mode():
        out, h = ops.rglru(x, la, st)
    assert out.grad_fn is None and h is st
    out, _ = ops.rglru(x, la)
    assert out.grad_fn is None


def test_wrapper_checks_its_inputs():
    x, la, h0, do, dh = _torch((1, 8, 4), "ref", True)
    with pytest.raises(ValueError, match="do must be"):
        kg.rglru_bwd(x, la, h0, do[:, :4])
    with pytest.raises(ValueError, match="do must be"):
        kg.rglru_bwd(x, la, h0, do.bfloat16())
    with pytest.raises(ValueError, match="dh must be"):
        kg.rglru_bwd(x, la, h0, do, dh[:, :2])
    with pytest.raises(ValueError, match="dh must be"):
        kg.rglru_bwd(x, la, h0, do, dh.double())
    with pytest.raises(ValueError, match="h0 must be"):
        kg.rglru_bwd(x, la, h0[:, :2], do)
    with pytest.raises(ValueError, match="log_a must be"):
        kg.rglru_bwd(x.bfloat16(), la.double(), h0, do.bfloat16())


def test_backward_off_cpu_never_falls_back_and_cpu_counts_no_launch():
    m = torch.empty((1, 8, 4), device="meta")
    before = kg.bwd_launches
    with pytest.raises(ValueError, match="device"):
        kg.rglru_bwd(m, m, None, m)
    x, la, h0, do, dh = _torch((1, 8, 4), "ref", True)
    kg.rglru_bwd(x, la, h0, do, dh)
    assert kg.bwd_launches == before
