"""The flash-attention backward: repro_torch's gradients against
``jax.grad`` of the JAX package's ``ops._flash`` (its custom VJP,
``_flash_bwd_impl``, at blocks of 128), and the row log-sum-exp against
``_flash_fwd_impl``'s.

On CPU tensors ``FlashAttention`` runs its plain versions
(``ref.attention_lse_ref`` forward, ``ref.flash_bwd_ref`` backward), the
same Function the model trains through on the card.  Inputs come from numpy
with a seed.  Tolerance: the reference's own between its VJP and autograd of
its oracle (tests/test_kernels.py), atol 5e-5 in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

ATOL = 5e-5
# (B, S, H, KV, D, causal, window, chunk, softcap): tests/test_kernels.py
# SWEEP 0, 3 and 4 (GQA, window 256, chunk 256), then MQA and softcap 30;
# then recurrentgemma-9b's local layers (MQA at D 256): causal, a window
# shorter than S, and a ragged S under a window
CASES = [
    (2, 256, 4, 2, 64, True, 0, 0, 0.0),
    (1, 1024, 4, 2, 64, True, 256, 0, 0.0),
    (1, 1024, 2, 2, 64, True, 0, 256, 0.0),
    (1, 512, 8, 1, 64, True, 0, 0, 0.0),
    (1, 256, 2, 2, 64, True, 0, 0, 30.0),
    (1, 256, 4, 1, 256, True, 0, 0, 0.0),
    (1, 512, 4, 1, 256, True, 128, 0, 0.0),
    (1, 300, 4, 1, 256, True, 128, 0, 0.0),
]


def _inputs(case, seed=0):
    B, S, H, KV, D = case[:5]
    rng = np.random.default_rng(seed)
    shapes = ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _mask_kw(case):
    return dict(causal=case[5], window=case[6], chunk=case[7], softcap=case[8])


def _jax_grads(case, q, k, v, do):
    causal, window, chunk, softcap = case[5:]

    def f(q, k, v):
        o = jops._flash(q, k, v, causal, window, chunk, softcap, 0, 128, 128)
        return (o * do).sum()

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("case", CASES)
def test_autograd_through_the_function_matches_jax_grad(case):
    q, k, v, do = _inputs(case)
    want = _jax_grads(case, q, k, v, do)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, **_mask_kw(case))
    assert o.grad_fn is not None and type(o.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_and_lse_match_the_reference_vjp(case):
    """flash_bwd_ref fed the reference forward's own (o, lse) gives the
    reference's (dq, dk, dv); attention_lse_ref's (o, lse) equal the
    reference forward's, lse laid out (B, H, Sq) with h = kv * G + g."""
    q, k, v, do = _inputs(case, seed=1)
    causal, window, chunk, softcap = case[5:]
    jo, jlse = jops._flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                    window, chunk, softcap, 0, 128, 128)
    B, S, H = q.shape[:3]
    jlse = np.asarray(jlse).reshape(B, H, S)
    o, lse = ref.attention_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)), **_mask_kw(case))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5)
    want = _jax_grads(case, q, k, v, do)
    got = ref.flash_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v, np.array(jo), jlse, do)),
                            **_mask_kw(case))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=f"d{name}")


def test_row_without_a_key_has_reference_lse_and_zero_grads():
    """Queries past the last key under a window of 2 attend nothing: their
    lse is -1e30 (the reference's m + log(1e-20)), their output and dq 0."""
    q, k, v, do = _inputs((1, 8, 2, 1, 16))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = ref.attention_lse_ref(tq, tk[:, :4], tv[:, :4], causal=True,
                                   window=2)
    assert torch.all(lse[:, :, 5:] == ref.NEG_INF) and torch.all(o[:, 5:] == 0)
    dq, dk, dv = ref.flash_bwd_ref(tq, tk[:, :4], tv[:, :4], o, lse, torch.from_numpy(do),
                                   causal=True, window=2)
    assert torch.all(dq[:, 5:] == 0) and torch.isfinite(dk).all() and torch.isfinite(dv).all()


def test_function_only_when_grad_is_needed():
    """Serving (no grad, or inference mode) keeps the forward alone, which
    writes no LSE; training takes the Function."""
    q, k, v, _ = _inputs((1, 32, 2, 1, 16))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with torch.inference_mode():
        assert ops.flash_attention(tq, tk, tv).grad_fn is None
    with torch.no_grad():
        assert ops.flash_attention(tq.requires_grad_(), tk, tv).grad_fn is None
    assert ops.flash_attention(tq, tk, tv).grad_fn is not None
    assert ops.flash_attention(tq.detach(), tk, tv).grad_fn is None


def test_bwd_wrapper_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs((1, 16, 2, 1, 16)))
    o, lse = fa.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd(q, k, v, o, lse[:, :1], do)
    with pytest.raises(ValueError, match="must match q"):
        fa.flash_attention_bwd(q, k, v, o.double(), lse, do)
    with pytest.raises(ValueError, match="must match q"):
        fa.flash_attention_bwd(q, k, v, o, lse, do[:, :8])
    before = (fa.launches, fa.lse_launches, fa.bwd_launches)
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert (fa.launches, fa.lse_launches, fa.bwd_launches) == before  # CPU counts nothing
