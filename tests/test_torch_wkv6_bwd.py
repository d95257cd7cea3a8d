"""repro_torch's WKV-6 backward against the JAX package: the plain version
(``ref.wkv6_bwd_ref``) and the autograd Function ``WKV6`` on CPU tensors vs
``jax.vjp`` of ``repro.kernels.ref.wkv6_ref`` (the reference's training
gradient: its Pallas kernel has no backward), with respect to r, k, v, w, u
and the initial state, with cotangents on both the output and the final
state.

Inputs come from numpy with a seed: the reference test's distribution
(decays in (0.45, 0.95)), and decays near 0 (about 1e-3) and near 1 (about
0.999), where the gradient must stay finite and exact.  Tolerance: f32
``atol 1e-5, rtol 1e-4`` (the same sums over at most 64 steps, taken in
another order by two frameworks)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as k6

ATOL, RTOL = 1e-5, 1e-4
SHAPES = [(1, 1, 2, 16), (2, 17, 4, 32), (1, 64, 2, 64), (2, 33, 2, 16)]
DECAYS = ("ref", "near0", "near1")
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")


def _inputs(B, S, H, D, decays, seed=0):
    """r, k, v, w, u, a state, and the cotangents do and ds, as numpy f32."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = n(B, S, H, D) * 0.5, n(B, S, H, D) * 0.5, n(B, S, H, D) * 0.5
    if decays == "ref":
        w = (1 / (1 + np.exp(-n(B, S, H, D)))) * 0.5 + 0.45
    elif decays == "near0":
        w = 1e-3 * (1 + 0.5 * rng.random((B, S, H, D)))
    else:
        w = 1 - 1e-3 * rng.random((B, S, H, D))
    u = n(H, D) * 0.3
    state = n(B, H, D, D) * 0.5
    do, ds = n(B, S, H, D), n(B, H, D, D)
    return [r, k, v, w.astype(np.float32), u, state, do, ds]


@functools.lru_cache(maxsize=None)
def _want(shape, decays, with_state):
    """(out, final state) and the six cotangents from jax.vjp, as numpy; the
    state is zeros when the case has none."""
    r, k, v, w, u, state, do, ds = (jnp.asarray(a) for a in _inputs(*shape, decays))
    if not with_state:
        state = jnp.zeros_like(state)
    (out, s_fin), vjp = jax.vjp(jref.wkv6_ref, r, k, v, w, u, state)
    grads = vjp((do, ds))
    return tuple(np.asarray(x) for x in (out, s_fin) + tuple(grads))


def _torch(shape, decays, with_state):
    r, k, v, w, u, state, do, ds = (torch.from_numpy(a) for a in _inputs(*shape, decays))
    return r, k, v, w, u, (state if with_state else None), do, ds


def _close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("decays", DECAYS)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_grad(shape, with_state, decays):
    r, k, v, w, u, state, do, ds = _torch(shape, decays, with_state)
    got = ref.wkv6_bwd_ref(r, k, v, w, u, state, do, ds)
    want = _want(shape, decays, with_state)
    assert [g.dtype for g in got] == [torch.float32] * 6
    assert got[4].shape == u.shape and got[5].shape == (shape[0], shape[2], shape[3], shape[3])
    for name, g, wnt in zip(NAMES, got, want[2:]):
        _close(g, wnt, name)


@pytest.mark.parametrize("decays", DECAYS)
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_function_gradients_match_jax_grad(shape, with_state, decays):
    """``ops.wkv6`` under grad takes ``WKV6``; a given state is updated in
    place to the final state (serving's contract), and the gradients, its
    own included, are still those of the state it was given."""
    r, k, v, w, u, state, do, ds = _torch(shape, decays, with_state)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    s_leaf = state.clone().requires_grad_() if with_state else None
    s_in = s_leaf * 1.0 if with_state else None  # a non-leaf, so it may be updated in place
    out, s_fin = ops.wkv6(*leaves, s_in)
    want = _want(shape, decays, with_state)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "WKV6Backward"
    _close(out, want[0], "out")
    _close(s_fin, want[1], "final state")
    if with_state:
        assert s_fin is s_in  # updated in place
    inputs = leaves + ([s_leaf] if with_state else [])
    grads = torch.autograd.grad((out, s_fin), inputs, (do, ds))
    for name, g, wnt in zip(NAMES, grads, want[2:]):
        _close(g, wnt, name)
    assert s_leaf is None or torch.equal(s_leaf, state)  # the caller's leaf is not touched


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3]])
def test_function_with_only_an_output_cotangent(shape):
    """The training path: the final state is dropped, so its cotangent is
    zero."""
    r, k, v, w, u, _, do, _ = _torch(shape, "ref", False)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    out, _ = ops.wkv6(*leaves, torch.zeros(shape[0], shape[2], shape[3], shape[3]))
    grads = torch.autograd.grad(out, leaves, do)
    want = ref.wkv6_bwd_ref(r, k, v, w, u, None, do, None)
    for name, g, wnt in zip(NAMES, grads, want):
        assert torch.equal(g, wnt), name


def test_bf16_inputs_give_gradients_in_the_inputs_dtypes():
    """u arrives in bf16 after the model's cast, so du comes back in bf16;
    dr, dk, dv, dw in the inputs' dtype, each the plain value rounded."""
    r, k, v, w, u, state, do, _ = _torch((2, 17, 4, 32), "ref", True)
    lo = [t.bfloat16().requires_grad_() for t in (r, k, v, w, u)]
    out, _ = ops.wkv6(*lo, state.clone())
    grads = torch.autograd.grad(out, lo, do.bfloat16())
    assert [g.dtype for g in grads] == [torch.bfloat16] * 5
    want = ref.wkv6_bwd_ref(*(t.detach() for t in lo), state, do.bfloat16())
    for name, g, wnt in zip(NAMES, grads, want):
        assert torch.equal(g, wnt.to(torch.bfloat16)), name


def test_serving_takes_the_forward_wrapper_alone():
    """Without grad (or with no input requiring it) ``ops.wkv6`` is the
    forward wrapper: no autograd node, the state updated in place."""
    r, k, v, w, u, state, _, _ = _torch((1, 8, 2, 16), "ref", True)
    st = state.clone()
    with torch.inference_mode():
        out, s = ops.wkv6(r, k, v, w, u, st)
    assert out.grad_fn is None and s is st
    out, _ = ops.wkv6(r, k, v, w, u)
    assert out.grad_fn is None


def test_wrapper_checks_the_cotangents():
    r, k, v, w, u, state, do, ds = _torch((1, 8, 2, 16), "ref", True)
    with pytest.raises(ValueError, match="do must be"):
        k6.wkv6_bwd(r, k, v, w, u, state, do[:, :4])
    with pytest.raises(ValueError, match="do must be"):
        k6.wkv6_bwd(r, k, v, w, u, state, do.bfloat16())
    with pytest.raises(ValueError, match="ds must be f32"):
        k6.wkv6_bwd(r, k, v, w, u, state, do, ds[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        k6.wkv6_bwd(r, k, v, w, u, state, do, ds.transpose(2, 3))


def test_backward_off_cpu_never_falls_back_and_cpu_counts_no_launch():
    m = torch.empty((1, 8, 2, 16), device="meta")
    before = k6.bwd_launches
    with pytest.raises(ValueError, match="device"):
        k6.wkv6_bwd(m, m, m, m, torch.empty((2, 16), device="meta"), None, m)
    r, k, v, w, u, state, do, ds = _torch((1, 8, 2, 16), "ref", True)
    k6.wkv6_bwd(r, k, v, w, u, state, do, ds)
    assert k6.bwd_launches == before
