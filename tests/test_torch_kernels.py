"""repro_torch kernels against the JAX package: the flash-attention
wrapper's plain path vs the Pallas kernel (interpret=True) and the jnp
oracle, decode attention vs its oracle, and the wrapper's input checks.

Inputs come from numpy with a seed and go through both packages.
Tolerances: f32 1e-5 (two frameworks summing in different orders on one
CPU), bf16 2e-2 (the reference's own bf16 tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as flash_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

# jitted once per static config: one XLA compile instead of one per op
attention_ref = jax.jit(jref.attention_ref, static_argnames=(
    "causal", "window", "chunk", "softcap", "q_offset"))
decode_attention_ref = jax.jit(jref.decode_attention_ref, static_argnames=(
    "window", "chunk", "softcap"))

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

SWEEP = [
    # (B, S, H, KV, D, causal, window, chunk) — tests/test_kernels.py SWEEP
    (2, 256, 4, 2, 64, True, 0, 0),
    (1, 512, 4, 4, 64, False, 0, 0),
    (1, 512, 8, 1, 64, True, 0, 0),      # MQA
    (1, 1024, 4, 2, 64, True, 256, 0),   # sliding window
    (1, 1024, 2, 2, 64, True, 0, 256),   # chunked
    (2, 256, 4, 4, 128, True, 0, 0),     # d_head 128
    (1, 256, 8, 2, 128, True, 0, 0),     # GQA 4:1, d_head 128 (rsc-llm's ratio)
]


def _qkv(B, S, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32))


def _both(arrs, dtype):
    j = [jnp.asarray(a).astype(JDT[dtype]) for a in arrs]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWEEP)
def test_plain_flash_matches_jax_oracle(case, dtype):
    B, S, H, KV, D, causal, window, chunk = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, S, H, KV, D), dtype)
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window, chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    want = attention_ref(jq, jk, jv, causal=causal, window=window, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [SWEEP[0], SWEEP[6]])
def test_plain_flash_matches_pallas_interpret(case, dtype):
    B, S, H, KV, D, causal, window, chunk = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(B, S, H, KV, D, seed=1), dtype)
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window, chunk=chunk)
    want = flash_pallas(jq, jk, jv, causal=causal, window=window, chunk=chunk,
                        block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("softcap,q_offset", [(30.0, 0), (0.0, 48), (20.0, 16)])
def test_ops_flash_softcap_and_offset_match_oracle(softcap, q_offset):
    q, k, v = _qkv(1, 64, 4, 2, 64, seed=2)
    q = q[:, : 64 - q_offset]
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "float32")
    got = ops.flash_attention(tq, tk, tv, softcap=softcap, q_offset=q_offset)
    want = attention_ref(jq, jk, jv, softcap=softcap, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_fully_masked_rows_are_zero():
    """A chunk/window mask that leaves no key for a row yields 0, as the
    reference's where-masking does (q_offset puts rows past every key)."""
    q, k, v = _qkv(1, 8, 2, 2, 64, seed=3)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "float32")
    got = ops.flash_attention(tq, tk, tv, causal=True, window=4, q_offset=20)
    want = attention_ref(jq, jk, jv, causal=True, window=4, q_offset=20)
    assert float(got.abs().max()) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["full", "ring"])
def test_decode_attention_matches_oracle(kind, dtype):
    B, L, H, KV, D = 2, 32, 8, 2, 64
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, 1, H, D), np.float32)
    kc = rng.standard_normal((B, L, KV, D), np.float32)
    vc = rng.standard_normal((B, L, KV, D), np.float32)
    if kind == "full":  # partly filled global cache: empty slots are -1
        pos = np.array([20, 9], np.int32)
        idx = np.arange(L)
        slot_pos = np.where(idx[None] <= pos[:, None], idx[None], -1).astype(np.int32)
    else:  # a ring that wrapped: slot i holds pos - ((pos - i) % L)
        pos = np.array([45, 70], np.int32)
        cand = pos[:, None] - ((pos[:, None] - np.arange(L)[None]) % L)
        slot_pos = np.where(cand >= 0, cand, -1).astype(np.int32)
        slot_pos[1, :3] = -1
    (jq, jk, jv), (tq, tk, tv) = _both((q, kc, vc), dtype)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(slot_pos).long(),
                               torch.from_numpy(pos).long())
    want = decode_attention_ref(jq, jk, jv, jnp.asarray(slot_pos), jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


@pytest.mark.parametrize("window,chunk,softcap", [(16, 0, 0.0), (0, 16, 25.0)])
def test_decode_attention_masks_match_oracle(window, chunk, softcap):
    B, L, H, KV, D = 2, 40, 4, 4, 16
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, 1, H, D), np.float32)
    kc = rng.standard_normal((B, L, KV, D), np.float32)
    vc = rng.standard_normal((B, L, KV, D), np.float32)
    pos = np.array([39, 33], np.int32)
    slot_pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    (jq, jk, jv), (tq, tk, tv) = _both((q, kc, vc), "float32")
    got = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(slot_pos).long(),
                                   torch.from_numpy(pos).long(), window=window,
                                   chunk=chunk, softcap=softcap)
    want = decode_attention_ref(jq, jk, jv, jnp.asarray(slot_pos), jnp.asarray(pos),
                                window=window, chunk=chunk, softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("q,k,v,match", [
    (_t((1, 8, 2, 48)), _t((1, 8, 2, 48)), _t((1, 8, 2, 48)), "head dim 48"),
    (_t((1, 8, 2, 64)), _t((1, 8, 2, 64), torch.bfloat16), _t((1, 8, 2, 64)), "dtype"),
    (_t((1, 8, 2, 64), torch.float16), _t((1, 8, 2, 64), torch.float16),
     _t((1, 8, 2, 64), torch.float16), "dtype"),
    (_t((1, 8, 2, 64)), _t((1, 8, 64, 2)).transpose(2, 3), _t((1, 8, 2, 64)), "contiguous"),
    (_t((1, 8, 3, 64)), _t((1, 8, 2, 64)), _t((1, 8, 2, 64)), "multiple"),
    (_t((1, 8, 2, 64)), _t((1, 8, 2, 64)), _t((1, 9, 2, 64)), "shapes"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(q, k, v, match):
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v)


def test_cpu_path_does_not_count_launches():
    before = fa.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 64))
    fa.flash_attention(q, k, v)
    assert fa.launches == before


def test_off_cpu_unported_shapes_raise():
    """On a non-CPU tensor there is no plain fallback: a tensor on neither
    the CPU nor the card raises, at Sq != Sk and q_offset too."""
    q = torch.empty((1, 4, 2, 64), device="meta")
    k = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(q, k, k, q_offset=4)
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention(q, q, q)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises with a clear message, never falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_library_is_named_by_a_hash_of_the_sources(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("int x;")
    before = _build._digest([a])
    assert _build._digest([a]) == before
    a.write_text("int y;")
    assert _build._digest([a]) != before
    assert len(_build._sources()) >= 1 and all(p.suffix == ".cu" for p in _build._sources())
