"""The chunked WKV-6 backward of ``csrc/wkv6_bwd_chunked.cu``, as its CPU
mirror ``wkv6.wkv6_chunked_bwd``, against ``jax.vjp`` of
``repro.kernels.ref.wkv6_ref`` (the reference's training gradient: its
Pallas kernel has no backward); and the wrapper's rule for which backward
kernel a call takes.

Inputs come from numpy with a seed and go through both packages: the
shapes and decays of tests/test_torch_wkv6_bwd.py (the reference test's
distribution, near 0, near 1) and decays exactly 0 in a fifth of the
entries; S = 17 and 33 end on a ragged chunk; every case runs with and
without an initial state and a final-state cotangent.

Tolerances, and why:
- unsplit, ``atol 1e-5, rtol 1e-4`` (tests/test_torch_wkv6_bwd.py's).  In
  f32 the mirror misses it in a few dw elements at (1, 64, 2, 64) with
  decays near 1, as PR 18's f32 plain version did (the states grow and a
  row sum cancels), so the unsplit mirror runs in f64: what is held is
  the algorithm, against the reference's own f32 rounding.
- split (the kernel's arithmetic: every product operand that is not an
  input as a two-term bf16 split, f32 sums), ``5e-5 * max(1, max|want|)``
  an output, chip_smoke.py's tolerance for the kernel against its plain
  version.  A split keeps 16 of f32's 24 bits, so each product is exact to
  ~2^-17 of its largest term; sums over up to 64 steps and 64 keys stay
  below 1e-5 of the output's largest magnitude (7.1e-6 at worst here).
- bf16 inputs (the kernel's dtype), the same plus one bf16 ulp (2^-7
  |want|) for dr, dk, dv, dw, against ``ref.wkv6_bwd_ref`` (f64 inside):
  chip_smoke.py's check of the kernel, here on its CPU mirror."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build, ref
from repro_torch.kernels import wkv6 as k6

ATOL, RTOL = 1e-5, 1e-4
SPLIT_TOL = 5e-5
SHAPES = [(1, 1, 2, 16), (2, 17, 4, 32), (1, 64, 2, 64), (2, 33, 2, 16)]
DECAYS = ("ref", "near0", "near1", "zero")
COTANGENTS = [(False, False), (True, False), (False, True), (True, True)]  # (state, ds)
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")


def _inputs(B, S, H, D, decays, seed=0):
    """r, k, v, w, u, a state, and the cotangents do and ds, as numpy f32.
    "zero" takes the reference test's decays and sets a fifth of them to
    exactly 0."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = n(B, S, H, D) * 0.5, n(B, S, H, D) * 0.5, n(B, S, H, D) * 0.5
    if decays in ("ref", "zero"):
        w = (1 / (1 + np.exp(-n(B, S, H, D)))) * 0.5 + 0.45
    elif decays == "near0":
        w = 1e-3 * (1 + 0.5 * rng.random((B, S, H, D)))
    else:
        w = 1 - 1e-3 * rng.random((B, S, H, D))
    if decays == "zero":
        w = np.where(rng.random(w.shape) < 0.2, 0.0, w)
    u = n(H, D) * 0.3
    state = n(B, H, D, D) * 0.5
    do, ds = n(B, S, H, D), n(B, H, D, D)
    return [r, k, v, w.astype(np.float32), u, state, do, ds]


@functools.lru_cache(maxsize=None)
def _want(shape, decays, with_state, with_ds):
    """The six cotangents from jax.vjp, as numpy; a missing state or final
    cotangent is zeros."""
    r, k, v, w, u, state, do, ds = (jnp.asarray(a) for a in _inputs(*shape, decays))
    if not with_state:
        state = jnp.zeros_like(state)
    if not with_ds:
        ds = jnp.zeros_like(ds)
    _, vjp = jax.vjp(jref.wkv6_ref, r, k, v, w, u, state)
    return tuple(np.asarray(x) for x in vjp((do, ds)))


def _torch(shape, decays, with_state, with_ds):
    r, k, v, w, u, state, do, ds = (torch.from_numpy(a) for a in _inputs(*shape, decays))
    return r, k, v, w, u, (state if with_state else None), do, (ds if with_ds else None)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("state,ds", COTANGENTS)
@pytest.mark.parametrize("decays", DECAYS)
@pytest.mark.parametrize("shape", SHAPES)
def test_chunked_backward_matches_jax_grad(shape, decays, state, ds, split):
    args = _torch(shape, decays, state, ds)
    got = k6.wkv6_chunked_bwd(*args, split=split,
                              dtype=torch.float32 if split else torch.float64)
    want = _want(shape, decays, state, ds)
    assert [g.dtype for g in got] == [torch.float32] * 6
    assert got[4].shape == (shape[2], shape[3])
    assert got[5].shape == (shape[0], shape[2], shape[3], shape[3])
    for name, g, wnt in zip(NAMES, got, want):
        g = g.numpy()
        assert np.isfinite(g).all(), name
        if split:
            lim = SPLIT_TOL * max(1.0, float(np.abs(wnt).max()))
            np.testing.assert_allclose(g, wnt, atol=lim, rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(g, wnt, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_other_chunk_lengths_give_the_same_gradient(chunk):
    """The chunked form holds for any chunk length (the kernel's is 16):
    S 33 is ragged for each."""
    args = _torch((2, 33, 2, 16), "zero", True, True)
    got = k6.wkv6_chunked_bwd(*args, chunk=chunk, split=False, dtype=torch.float64)
    for name, g, wnt in zip(NAMES, got, _want((2, 33, 2, 16), "zero", True, True)):
        np.testing.assert_allclose(g.numpy(), wnt, atol=ATOL, rtol=RTOL, err_msg=name)


def _bf16_close(got, want):
    for n, (name, g, wnt) in enumerate(zip(NAMES, got, want)):
        g, wnt = g.float(), wnt.float()
        lim = SPLIT_TOL * max(1.0, float(wnt.abs().max()))
        if n < 4:
            lim = lim + 2.0 ** -7 * wnt.abs()
        assert bool(((g - wnt).abs() <= lim).all()), name


@pytest.mark.parametrize("decays", ["ref", 1e-3, 0.999, 0.0])
@pytest.mark.parametrize("D", k6.HEAD_DIMS)
def test_bf16_mirror_matches_plain_version(D, decays):
    """The kernel's dtype, at chip_smoke.py's ragged (2, 77, 4, D) case with
    a state and a final-state cotangent, and its check."""
    arrs = _inputs(2, 77, 4, D, "ref", seed=D)
    if decays != "ref":
        arrs[3] = np.full_like(arrs[3], decays)
    r, k, v, w, u, state, do, ds = (torch.from_numpy(a) for a in arrs)
    args = [t.bfloat16() for t in (r, k, v, w, u)] + [state, do.bfloat16(), ds]
    got = k6.wkv6_chunked_bwd(*args)
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [torch.float32] * 2
    _bf16_close(got, ref.wkv6_bwd_ref(*args))


def test_bf16_mirror_matches_plain_version_at_training_values():
    """rwkv6-7b's training values (chip_smoke.py's make_wkv_main_path), the
    slowest and the fastest heads, no state and no final-state cotangent:
    decays w = exp(-exp(w0 + N(0, 0.1^2))) with w0 the model's
    linspace(-6, -0.5) (the slow channels round to 0.99609 or 1.0 in bf16),
    r, k, v, dO ~ N(0, 1)."""
    rng = np.random.default_rng(4)
    S, D, heads = 256, 64, [0, 63]
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w0 = np.linspace(-6.0, -0.5, 64 * D, dtype=np.float32).reshape(64, D)[heads]
    r, k, v, do = (n(1, S, 2, D) for _ in range(4))
    w = np.exp(-np.exp(w0 + n(1, S, 2, D) * 0.1)).astype(np.float32)
    args = [torch.from_numpy(a).bfloat16() for a in (r, k, v, w, n(2, D) * 0.3)]
    args += [None, torch.from_numpy(do).bfloat16(), None]
    _bf16_close(k6.wkv6_chunked_bwd(*args), ref.wkv6_bwd_ref(*args))


def test_backward_designs_route_by_dtype():
    """bf16 takes the chunked tensor-core design, f32 the CUDA-core one;
    each design's entry point is a C function of the sources _build
    compiles."""
    assert k6.BWD_DESIGNS == {torch.bfloat16: k6.BWD_CHUNKED, torch.float32: k6.BWD_TWO_SCAN}
    assert set(k6.bwd_kernel_launches) == set(k6.BWD_ENTRY) == {k6.BWD_CHUNKED, k6.BWD_TWO_SCAN}
    sources = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for entry in k6.BWD_ENTRY.values():
        assert f'extern "C" int {entry}(' in sources, entry


def test_kernel_override_is_checked():
    r, k, v, w, u, state, do, ds = _torch((1, 8, 2, 16), "ref", True, True)
    with pytest.raises(ValueError, match="unknown backward kernel"):
        k6.wkv6_bwd(r, k, v, w, u, state, do, ds, kernel="no such design")
    with pytest.raises(ValueError, match="chunked backward takes bf16"):
        k6.wkv6_bwd(r, k, v, w, u, state, do, ds, kernel=k6.BWD_CHUNKED)
    lo = [t.bfloat16() for t in (r, k, v, w, u)]
    want = ref.wkv6_bwd_ref(*lo, state, do.bfloat16(), ds)
    for kernel in (None, k6.BWD_CHUNKED, k6.BWD_TWO_SCAN):  # the CPU takes the plain version
        got = k6.wkv6_bwd(*lo, state, do.bfloat16(), ds, kernel=kernel)
        for name, g, wnt in zip(NAMES, got, want):
            assert torch.equal(g, wnt), name


@pytest.mark.parametrize("kernel", [None, "mma.sync chunked", "cuda-core two-scan"])
def test_backward_off_cpu_never_falls_back(kernel):
    """A tensor that is not on the CPU launches its design or raises; the
    CPU's plain version counts no launch of either design."""
    m = torch.empty((1, 8, 2, 16), device="meta", dtype=torch.bfloat16)
    before = dict(k6.bwd_kernel_launches), k6.bwd_launches
    with pytest.raises(ValueError, match="unsupported device"):
        k6.wkv6_bwd(m, m, m, m, torch.empty((2, 16), device="meta"), None, m, kernel=kernel)
    r, k, v, w, u, state, do, ds = _torch((1, 8, 2, 16), "ref", True, True)
    k6.wkv6_bwd(*(t.bfloat16() for t in (r, k, v, w, u)), state, do.bfloat16(), ds,
                kernel=kernel)
    assert (dict(k6.bwd_kernel_launches), k6.bwd_launches) == before
