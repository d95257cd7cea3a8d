"""The chunked WKV-6 algorithm of ``csrc/wkv6_chunked.cu``, as its CPU
mirror ``wkv6.wkv6_chunked``, against the JAX package: the jnp oracle
(``repro.kernels.ref.wkv6_ref``) and, where there is no state, the Pallas
kernel in interpret mode; and the wrapper's rule for which kernel a CUDA
call takes.

Inputs come from numpy with a seed and go through both packages.  The
mirror runs the kernel's arithmetic: chunks of ``chunk`` steps, decays as
running products inside a chunk, and with ``split`` the two-term bf16
splits of rt, kt, S and A with f32 sums.  Tolerances are the reference's own
(tests/test_kernels.py): f32 5e-5, bf16 5e-2.  A bf16 output above 8 may
also differ by one bf16 ulp (2^-7 |want|), as chip_smoke.py allows: the two
sides round f32 sums taken in different orders."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import wkv6 as wkv6_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as k6

TOL = {"float32": 5e-5, "bfloat16": 5e-2}
REL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [(1, 128, 2, 16), (2, 256, 4, 32), (1, 64, 8, 64)]  # tests/test_kernels.py
CHUNKS = [16, 32, 64]

wkv6_jref = jax.jit(jref.wkv6_ref)


def _inputs(B, S, H, D, seed=0, state=False):
    """The reference test's distribution as numpy f32: r, k, v ~ N(0, 0.5^2),
    w in (0.45, 0.95), u ~ N(0, 0.3^2), a state ~ N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    r, k, v = n(B, S, H, D) * 0.5, n(B, S, H, D) * 0.5, n(B, S, H, D) * 0.5
    w = ((1 / (1 + np.exp(-n(B, S, H, D)))) * 0.5 + 0.45).astype(np.float32)
    out = [r, k, v, w, n(H, D) * 0.3]
    if state:
        out.append(n(B, H, D, D) * 0.5)
    return out


def _main_path_inputs(S, heads, seed=2):
    """rwkv6-7b's prefill values (chip_smoke.py's make_wkv_main_path), B 1,
    for a few of its 64 heads: w = exp(-exp(w0 + N(0, 0.1^2))) with w0 the
    model's linspace(-6, -0.5) over all 64 x 64 channels (head 0 is the
    slowest: its w rounds to 0.99609 or 1.0 in bf16), r, k, v ~ N(0, 1),
    u ~ N(0, 0.3^2), a zero state."""
    rng = np.random.default_rng(seed)
    H, D = len(heads), 64
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w0 = np.linspace(-6.0, -0.5, 64 * D, dtype=np.float32).reshape(64, D)[heads]
    r, k, v = n(1, S, H, D), n(1, S, H, D), n(1, S, H, D)
    w = np.exp(-np.exp(w0 + n(1, S, H, D) * 0.1)).astype(np.float32)
    return [r, k, v, w, n(H, D) * 0.3]


def _jax(arrs, dtype):
    return [jnp.asarray(a).astype(JDT[dtype] if i < 5 else jnp.float32)
            for i, a in enumerate(arrs)]


def _torch(arrs, dtype):
    return [torch.tensor(a).to(TDT[dtype] if i < 5 else torch.float32)
            for i, a in enumerate(arrs)]


def _want(arrs, dtype, oracle="jnp"):
    """The JAX result as numpy f32."""
    j = _jax(arrs, dtype)
    if oracle == "pallas":
        out, s = wkv6_pallas(*j, chunk=32, interpret=True)
    else:
        out, s = wkv6_jref(*j)
    return np.asarray(out, np.float32), np.asarray(s, np.float32)


@functools.lru_cache(maxsize=None)
def _want_cached(shape, dtype, oracle, state=False):
    return _want(_inputs(*shape, state=state), dtype, oracle)


def _check(got, want, dtype):
    out, s = got
    assert s.dtype == torch.float32
    o = out.float().numpy()
    assert np.isfinite(o).all() and np.isfinite(s.numpy()).all()
    d = np.abs(o - want[0])
    lim = TOL[dtype] + REL[dtype] * np.abs(want[0])
    assert (d <= lim).all(), f"max |d| out {d.max():.3e}"
    np.testing.assert_allclose(s.numpy(), want[1], atol=TOL[dtype])


# f32 inputs: the chunked algorithm with f32 products; bf16 inputs: the
# kernel's split arithmetic (and the algorithm alone)
SPLITS = [("float32", False), ("bfloat16", True), ("bfloat16", False)]


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("oracle", ["jnp", "pallas"])
@pytest.mark.parametrize("dtype,split", SPLITS)
@pytest.mark.parametrize("shape", SHAPES)
def test_chunked_matches_jax(shape, dtype, split, oracle, chunk):
    t = _torch(_inputs(*shape), dtype)
    got = k6.wkv6_chunked(*t, chunk=chunk, split=split)
    assert got[0].dtype == TDT[dtype] and got[0].shape == shape
    _check(got, _want_cached(shape, dtype, oracle), dtype)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype,split", SPLITS[:2])
@pytest.mark.parametrize("shape,state", [
    ((2, 100, 4, 64), False),  # ragged: 100 is no multiple of 16, 32 or 64
    ((2, 77, 4, 32), True),    # ragged, with an initial state
    ((4, 1, 8, 64), True),     # S = 1 with a state: one decode step
    ((3, 5, 2, 16), True),
])
def test_chunked_ragged_and_stateful_match_jax_ref(shape, state, dtype, split, chunk):
    """The Pallas kernel rejects a state, so the oracle is the jnp one."""
    arrs = _inputs(*shape, seed=3, state=state)
    t = _torch(arrs, dtype)
    s0 = None if not state else t[5].clone()
    got = k6.wkv6_chunked(*t, chunk=chunk, split=split)
    if state:
        assert torch.equal(t[5], s0)  # the mirror leaves a given state alone
    _check(got, _want(arrs, dtype), dtype)


DECAYS = {"zero": 0.0, "one": 1.0, "tiny": 1e-30}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("dtype,split", SPLITS[:2])
@pytest.mark.parametrize("decay", list(DECAYS) + ["mixed"])
def test_chunked_extreme_decays_match_jax_ref(decay, dtype, split, chunk):
    """w exactly 0, exactly 1 and 1e-30 (its products underflow to 0), and
    a mix of those with ordinary decays: no NaN, and the same result as the
    sequential product, with an initial state and a ragged S."""
    arrs = _inputs(2, 77, 4, 32, seed=4, state=True)
    if decay == "mixed":
        pick = np.random.default_rng(5).integers(0, 4, arrs[3].shape)
        arrs[3] = np.choose(pick, [arrs[3], np.float32(0.0), np.float32(1.0),
                                   np.float32(1e-30)]).astype(np.float32)
    else:
        arrs[3] = np.full_like(arrs[3], DECAYS[decay])
    got = k6.wkv6_chunked(*_torch(arrs, dtype), chunk=chunk, split=split)
    _check(got, _want(arrs, dtype), dtype)


@functools.lru_cache(maxsize=None)
def _main_path_want():
    arrs = _main_path_inputs(2048, [0, 1, 32, 63])
    return arrs, _want(arrs, "bfloat16")


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_split_passes_the_card_check_at_main_path_values(chunk):
    """S 2048, D 64, the slowest heads of rwkv6-7b and two faster ones, in
    bf16: the split arithmetic passes chip_smoke.py's check of the kernel at
    this shape (out within 5e-2 + 2^-7 |want|, state within 5e-2)."""
    arrs, want = _main_path_want()
    got = k6.wkv6_chunked(*_torch(arrs, "bfloat16"), chunk=chunk, split=True)
    assert np.abs(want[1]).max() > 20  # the slow heads' state sums most of the 2048 steps
    _check(got, want, "bfloat16")
    assert np.abs(got[1].numpy() - want[1]).max() < 1e-3


def test_chunked_state_continuity():
    """40 + 24 steps with the state carried == 64 steps at once."""
    t = _torch(_inputs(1, 64, 2, 16, seed=1), "float32")
    full, s_full = k6.wkv6_chunked(*t, chunk=16, split=False)
    a, st = k6.wkv6_chunked(*(x[:, :40] for x in t[:4]), t[4], chunk=16, split=False)
    b, s_b = k6.wkv6_chunked(*(x[:, 40:] for x in t[:4]), t[4], st, chunk=16, split=False)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), full.numpy(), atol=1e-5)
    np.testing.assert_allclose(s_b.numpy(), s_full.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_matches_the_port_plain_version(dtype):
    t = _torch(_inputs(2, 50, 2, 32, seed=6, state=True), dtype)
    want = ref.wkv6_ref(*t)
    got = k6.wkv6_chunked(*t, split=dtype == "bfloat16")
    _check(got, (want[0].float().numpy(), want[1].numpy()), dtype)


# ---- which kernel a CUDA call takes

def test_designs_route_by_dtype():
    """bf16 takes the chunked tensor-core kernel and f32 the sequential
    CUDA-core one; the length does not enter the rule (the card test
    test_wkv6_routes_by_dtype_on_card launches S 1, 16 and 100)."""
    assert k6.design(torch.bfloat16) == k6.CHUNKED
    assert k6.design(torch.float32) == k6.SEQUENTIAL
    assert set(k6.ENTRY) == {k6.CHUNKED, k6.SEQUENTIAL}
    assert k6.ENTRY[k6.CHUNKED] == "wkv6_chunked_fwd" and k6.ENTRY[k6.SEQUENTIAL] == "wkv6_fwd"


def test_design_rejects_other_dtypes():
    with pytest.raises(ValueError, match="dtype"):
        k6.design(torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_off_cpu_tensors_never_fall_back(dtype):
    """A tensor that is neither on the CPU nor on the card raises, in either
    dtype; the plain version is not taken and no launch is counted."""
    m = torch.empty((1, 8, 2, 16), device="meta", dtype=dtype)
    before = k6.launches
    with pytest.raises(ValueError, match="device"):
        ops.wkv6(m, m, m, m, torch.empty((2, 16), device="meta"))
    assert k6.launches == before


def test_cpu_path_takes_misaligned_views():
    """The 16-byte rule is the chunked kernel's; the plain version takes any
    view."""
    big = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 6, 2, 20)).astype(
        np.float32)).bfloat16()
    r = big[..., 2:18]  # starts 4 bytes in
    assert not fa.aligned_for_tma(r)
    u = torch.zeros((2, 16))
    got = k6.wkv6(r, r, r, torch.full_like(r, 0.5), u)
    want = ref.wkv6_ref(r.contiguous(), r.contiguous(), r.contiguous(),
                        torch.full_like(r, 0.5).contiguous(), u)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
