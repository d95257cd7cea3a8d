"""repro_torch's WKV-6 against the JAX package: the plain version
(``ref.wkv6_ref``) and the wrapper on CPU tensors vs the jnp oracle and the
Pallas kernel (interpret=True), with and without an initial state, and the
wrapper's input checks.

Inputs come from numpy with a seed (the reference test's distribution) and
go through both packages.  Tolerances are the reference's own
(tests/test_kernels.py): f32 5e-5, bf16 5e-2."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import wkv6 as wkv6_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as k6

TOL = {"float32": 5e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [(1, 128, 2, 16), (2, 256, 4, 32), (1, 64, 8, 64)]  # tests/test_kernels.py
FNS = {"plain": ref.wkv6_ref, "wrapper": k6.wkv6}

wkv6_jref = jax.jit(jref.wkv6_ref)


def _inputs(B, S, H, D, seed=0, state=False):
    """r, k, v, w, u (and a state) as numpy f32."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = n(B, S, H, D) * 0.5, n(B, S, H, D) * 0.5, n(B, S, H, D) * 0.5
    w = (1 / (1 + np.exp(-n(B, S, H, D)))) * 0.5 + 0.45
    u = n(H, D) * 0.3
    out = [r, k, v, w.astype(np.float32), u]
    if state:
        out.append(n(B, H, D, D) * 0.5)
    return out


def _jax(arrs, dtype):
    """The five inputs in ``dtype``, an optional state in f32."""
    return [jnp.asarray(a).astype(JDT[dtype] if i < 5 else jnp.float32)
            for i, a in enumerate(arrs)]


def _torch(arrs, dtype):
    return [torch.tensor(a).to(TDT[dtype] if i < 5 else torch.float32)
            for i, a in enumerate(arrs)]


@functools.lru_cache(maxsize=None)
def _want(shape, dtype, oracle, state=False):
    """The JAX result for one case, as numpy f32 (computed once per case)."""
    j = _jax(_inputs(*shape, state=state), dtype)
    if oracle == "pallas":
        out, s = wkv6_pallas(*j, chunk=32, interpret=True)
    else:
        out, s = wkv6_jref(*j)
    return np.asarray(out, np.float32), np.asarray(s, np.float32)


def _check(got, want, dtype):
    out, s = got
    assert s.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), want[0], atol=TOL[dtype])
    np.testing.assert_allclose(s.numpy(), want[1], atol=TOL[dtype])


@pytest.mark.parametrize("fn", list(FNS))
@pytest.mark.parametrize("oracle", ["jnp", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_wkv6_matches_jax(shape, dtype, oracle, fn):
    t = _torch(_inputs(*shape), dtype)
    got = FNS[fn](*t)
    assert got[0].dtype == TDT[dtype] and got[0].shape == shape
    _check(got, _want(shape, dtype, oracle), dtype)


@pytest.mark.parametrize("fn", list(FNS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2], (2, 1, 4, 32)])
def test_wkv6_with_initial_state_matches_jax_ref(shape, dtype, fn):
    """The Pallas kernel rejects a state, so the oracle is the jnp one."""
    t = _torch(_inputs(*shape, state=True), dtype)
    _check(FNS[fn](*t), _want(shape, dtype, "jnp", state=True), dtype)


def test_wkv6_state_continuity():
    """40 + 24 steps with the state carried == 64 steps at once."""
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(1, 64, 2, 16, seed=1))
    full, s_full = ops.wkv6(r, k, v, w, u)
    a, st = ops.wkv6(r[:, :40], k[:, :40], v[:, :40], w[:, :40], u)
    b, s_b = ops.wkv6(r[:, 40:], k[:, 40:], v[:, 40:], w[:, 40:], u, st)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), full.numpy(), atol=1e-5)
    np.testing.assert_allclose(s_b.numpy(), s_full.numpy(), atol=1e-5)


def test_one_step_with_state_is_the_last_step_of_the_sequence():
    r, k, v, w, u = (torch.from_numpy(a) for a in _inputs(2, 33, 4, 32, seed=2))
    full, s_full = ops.wkv6(r, k, v, w, u)
    _, st = ops.wkv6(r[:, :-1], k[:, :-1], v[:, :-1], w[:, :-1], u)
    one, s_one = ops.wkv6(r[:, -1:], k[:, -1:], v[:, -1:], w[:, -1:], u, st)
    assert s_one is st  # updated in place
    np.testing.assert_allclose(one[:, 0].numpy(), full[:, -1].numpy(), atol=1e-5)
    np.testing.assert_allclose(s_one.numpy(), s_full.numpy(), atol=1e-5)


def _z(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


R = _z((1, 8, 2, 16))
U = _z((2, 16))


@pytest.mark.parametrize("args,kw,match", [
    ((_z((1, 8, 2, 48)),) * 4 + (_z((2, 48)),), {}, "head dim 48"),
    ((_z((1, 8, 2, 16), torch.float16),) * 4 + (U,), {}, "dtype"),
    ((R, R, R, _z((1, 8, 2, 16), torch.bfloat16), U), {}, "dtype"),
    ((R, R, _z((1, 9, 2, 16)), R, U), {}, "shapes"),
    ((R, R, R, R, _z((3, 16))), {}, "u must be"),
    ((R, R, R, R, U, _z((1, 2, 16, 16), torch.bfloat16)), {}, "state must be f32"),
    ((R, R, R, R, U, _z((1, 2, 16, 8))), {}, "state must be f32"),
    ((R, R, R, R, U, _z((1, 2, 16, 16)).transpose(2, 3)), {}, "contiguous"),
    ((R, R, R, R, U, _z((2, 2, 16, 16))), {}, "state must be f32"),
    ((R, _z((1, 2, 16, 8)).permute(0, 3, 1, 2), R, R, U), {}, "contiguous"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(args, kw, match):
    with pytest.raises(ValueError, match=match):
        k6.wkv6(*args, **kw)


def test_off_cpu_tensors_never_fall_back():
    """A tensor that is neither on the CPU nor on the card raises; the
    plain version is not taken."""
    m = torch.empty((1, 8, 2, 16), device="meta")
    before = k6.launches
    with pytest.raises(ValueError, match="device"):
        ops.wkv6(m, m, m, m, torch.empty((2, 16), device="meta"))
    assert k6.launches == before


def test_cpu_path_does_not_count_launches():
    before = k6.launches
    k6.wkv6(*(torch.from_numpy(a) for a in _inputs(1, 8, 2, 16)))
    assert k6.launches == before
