"""repro_torch's RG-LRU and causal conv against the JAX package: the plain
version (``ref.rglru_ref``) and the wrapper on CPU tensors vs the jnp
sequential oracle and the Pallas kernel (interpret=True), with and without
an initial state; ``ops.rglru`` vs the reference's associative scan; the
wrapper's input checks; ``ops.causal_conv1d`` with and without a carried
context.

Inputs come from numpy with a seed (the reference test's distribution:
x ~ N(0, 1), log_a = -softplus(N(0, 1)), h0 ~ N(0, 1)) and go through both
packages.  Tolerances: 1e-5 in f32 against the sequential oracle and the
Pallas kernel (the same f32 arithmetic in the same order, two libraries'
exp); 1e-4 against the associative scan (the reference's own tolerance
between its two forms, tests/test_kernels.py); one bf16 ulp for a bf16
output (both round the same f32 value, which may sit on either side of a
rounding boundary); 1e-6 for the f32 conv and exact equality for the bf16
conv (the same elementwise products and sums, rounded at each step)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru as rglru_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru as kg

ATOL = 1e-5
SHAPES = [(1, 128, 64), (2, 256, 128), (1, 64, 512)]  # tests/test_kernels.py
FNS = {"plain": ref.rglru_ref, "wrapper": kg.rglru}

rglru_jref = jax.jit(jref.rglru_ref)


def _inputs(B, S, W, seed=0):
    """x, log_a, h0 as numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    la = -np.logaddexp(rng.standard_normal((B, S, W)), 0.0).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return x, la, h0


@functools.lru_cache(maxsize=None)
def _want(shape, oracle, with_h0, seed=0):
    """The JAX result for one case, as numpy f32 (computed once per case)."""
    x, la, h0 = (jnp.asarray(a) for a in _inputs(*shape, seed=seed))
    h0 = h0 if with_h0 else None
    if oracle == "pallas":
        out, h = rglru_pallas(x, la, h0, chunk=64, block_w=64, interpret=True)
    else:
        out, h = rglru_jref(x, la, h0)
    return np.asarray(out, np.float32), np.asarray(h, np.float32)


@pytest.mark.parametrize("fn", list(FNS))
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("oracle", ["jnp", "pallas"])
@pytest.mark.parametrize("shape", SHAPES)
def test_rglru_matches_jax(shape, oracle, with_h0, fn):
    x, la, h0 = (torch.from_numpy(a) for a in _inputs(*shape))
    out, h = FNS[fn](x, la, h0 if with_h0 else None)
    want_out, want_h = _want(shape, oracle, with_h0)
    assert out.dtype == torch.float32 and out.shape == shape and h.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), want_h, atol=ATOL)


@pytest.mark.parametrize("fn", list(FNS))
def test_bf16_x_with_f32_log_a_within_one_ulp(fn):
    """The main path's types: x bf16, log_a f32, state f32."""
    x, la, h0 = _inputs(2, 96, 64, seed=1)
    want, want_h = jref.rglru_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(la),
                                  jnp.asarray(h0))
    got, h = FNS[fn](torch.from_numpy(x).bfloat16(), torch.from_numpy(la),
                     torch.from_numpy(h0))
    assert got.dtype == torch.bfloat16 and h.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)


@pytest.mark.parametrize("fn", list(FNS))
def test_one_step_with_state_matches_jax(fn):
    """The decode shape: S = 1 with the carried state."""
    x, la, h0 = _inputs(4, 1, 64, seed=2)
    want, want_h = jref.rglru_ref(*(jnp.asarray(a) for a in (x, la, h0)))
    got, h = FNS[fn](*(torch.from_numpy(a) for a in (x, la, h0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=ATOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ops_rglru_matches_jax_associative_scan(with_h0):
    x, la, h0 = _inputs(2, 192, 96, seed=3)
    j = [jnp.asarray(a) for a in (x, la)] + [jnp.asarray(h0) if with_h0 else None]
    want, want_h = jops.rglru(*j)
    got, h = ops.rglru(torch.from_numpy(x), torch.from_numpy(la),
                       torch.from_numpy(h0) if with_h0 else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-4)


def test_rglru_state_continuity():
    """40 + 24 steps with the state carried (in place) == 64 steps at once."""
    x, la, _ = (torch.from_numpy(a) for a in _inputs(2, 64, 32, seed=4))
    full, h_full = ops.rglru(x, la)
    st = torch.zeros((2, 32))
    a, _ = ops.rglru(x[:, :40], la[:, :40], st)
    b, h_b = ops.rglru(x[:, 40:], la[:, 40:], st)
    assert h_b is st
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), full.numpy(), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), h_full.numpy(), atol=1e-6)


def test_cpu_wrapper_updates_state_in_place_and_counts_no_launch():
    x, la, h0 = (torch.from_numpy(a) for a in _inputs(2, 16, 32, seed=5))
    want, want_h = ref.rglru_ref(x, la, h0.clone())
    before = kg.launches
    st = h0.clone()
    out, h = kg.rglru(x, la, st)
    assert kg.launches == before
    assert h is st and torch.equal(st, want_h) and torch.equal(out, want)


def _z(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


X = _z((2, 8, 16))


@pytest.mark.parametrize("args,match", [
    ((_z((2, 8, 16, 1)), _z((2, 8, 16, 1))), r"\(B, S, W\)"),
    ((X, _z((2, 9, 16))), r"\(B, S, W\)"),
    ((_z((2, 8, 16), torch.float16), _z((2, 8, 16), torch.float16)), "x must be"),
    ((X, _z((2, 8, 16), torch.bfloat16)), "log_a must be"),
    ((_z((2, 8, 16), torch.bfloat16), _z((2, 8, 16), torch.float16)), "log_a must be"),
    ((X, _z((2, 16, 8)).transpose(1, 2)), "contiguous"),
    ((X, X, _z((2, 16), torch.bfloat16)), "h0 must be f32"),
    ((X, X, _z((3, 16))), "h0 must be f32"),
    ((X, X, _z((16, 2)).t()), "contiguous"),
    ((X, torch.empty((2, 8, 16), device="meta")), "log_a on meta"),
    ((X, X, torch.empty((2, 16), device="meta")), "h0 on meta"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        kg.rglru(*args)


def test_off_cpu_tensors_never_fall_back():
    """A tensor that is neither on the CPU nor on the card raises; the
    plain version is not taken."""
    m = torch.empty((1, 8, 16), device="meta")
    before = kg.launches
    with pytest.raises(ValueError, match="device"):
        ops.rglru(m, m)
    assert kg.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,with_state", [(1, True), (1, False), (4, False), (37, True)])
def test_causal_conv1d_matches_jax(S, with_state, dtype):
    rng = np.random.default_rng(S)
    B, W, K = 2, 24, 4
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    w = rng.standard_normal((K, W)).astype(np.float32) * 0.5
    st = rng.standard_normal((B, K - 1, W)).astype(np.float32) if with_state else None
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want, want_st = jops.causal_conv1d(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), None if st is None else jnp.asarray(st))
    got, got_st = ops.causal_conv1d(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
        None if st is None else torch.from_numpy(st))
    assert got.dtype == got_st.dtype == tdt and got_st.shape == (B, K - 1, W)
    atol = 1e-6 if dtype == "float32" else 0.0
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol)
    np.testing.assert_allclose(got_st.float().numpy(),
                               np.asarray(want_st.astype(jnp.float32)), atol=atol)


def test_causal_conv1d_state_continuity():
    """conv over a split sequence with carried state == conv over the whole
    (the counterpart of tests/test_kernels.py's case)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 64, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    full, _ = ops.causal_conv1d(x, w)
    a, st = ops.causal_conv1d(x[:, :40], w)
    b, _ = ops.causal_conv1d(x[:, 40:], w, st)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), full.numpy(), atol=1e-6)
