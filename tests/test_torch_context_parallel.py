"""Context-parallel attention and the flash kernels' query offset, against
the JAX package.

* CP on 8 CPU ranks (a 2 x 4 ("data", "model") mesh, gloo) at the reference
  CP test's shape (2, 2048, 6 / 2 heads, 64): 6 heads do not divide the
  model dim of 4, so each model rank runs the flash kernel's plain version
  on its 512 query rows at q_offset = rank * 512 against all 2048 keys.
  Output and gradients are held to the JAX ``ref.attention_ref`` and its
  ``jax.grad`` at the reference test's 5e-6 and 5e-5
  (tests/test_context_parallel.py).
* ``ops.flash_attention`` and the wrappers at q_offset != 0 and with a mask
  at Sq != Sk against the JAX package's blocked ``ops._flash_fwd_impl`` and
  ``ops._flash_bwd_impl``.
* ``tile_class`` at an offset against a brute-force mask, and CP inactive
  without a mesh.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from tests.test_torch_parallel import run_jax, run_ranks

CP_SHAPE = (2, 2048, 6, 2, 64)  # B, S, H, KV, D


def _qkv(B, Sq, Sk, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    do = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    return q, k, v, do


def test_cp_matches_jax_oracle_fwd_and_grads(tmp_path):
    B, S, H, KV, D = CP_SHAPE
    q, k, v, do = _qkv(B, S, S, H, KV, D)
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v, do=do)
    run_jax(f"""
        import jax, jax.numpy as jnp, numpy as np
        from repro.kernels import ref
        d = {{n: jnp.asarray(a) for n, a in np.load({str(tmp_path / 'in.npz')!r}).items()}}
        o = ref.attention_ref(d["q"], d["k"], d["v"], causal=True)
        g = jax.grad(lambda q, k, v: (ref.attention_ref(q, k, v, causal=True) * d["do"]).sum(),
                     argnums=(0, 1, 2))(d["q"], d["k"], d["v"])
        np.savez({str(tmp_path / 'jax.npz')!r}, o=o, dq=g[0], dk=g[1], dv=g[2])
        print("OK")
    """, 1)
    run_ranks("""
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.parallel.axes import TRAIN_RULES, mesh_context
        mesh = make_test_mesh(2, 4, device_type="cpu")
        d = {n: torch.from_numpy(a) for n, a in np.load(os.path.join(OUT, "in.npz")).items()}
        rep = [Replicate(), Replicate()]
        q, k, v = (DTensor.from_local(d[n], mesh, rep).requires_grad_() for n in "qkv")
        do = DTensor.from_local(d["do"], mesh, rep)
        offsets = []
        local = ops._flash_local
        def spy(qs, ks, vs, causal, window, chunk, softcap, q_offset):
            offsets.append((tuple(qs.shape), tuple(ks.shape), q_offset))
            return local(qs, ks, vs, causal, window, chunk, softcap, q_offset)
        ops._flash_local = spy
        with mesh_context(mesh, TRAIN_RULES):
            o = ops.flash_attention(q, k, v, causal=True)
            (o * do).sum().backward()
        rank = mesh.get_local_rank("model")
        # each model rank: its batch row, its 512 query rows at its offset, all keys
        assert offsets == [((1, 512, 6, 64), (1, 2048, 2, 64), 512 * rank)], offsets
        full = {"o": o.full_tensor(), "dq": q.grad.full_tensor(), "dk": k.grad.full_tensor(),
                "dv": v.grad.full_tensor()}
        if RANK == 0:
            np.savez(os.path.join(OUT, "torch.npz"),
                     **{n: t.detach().numpy() for n, t in full.items()})
        dist.barrier()
        dist.destroy_process_group()
    """, 8, tmp_path)
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "torch.npz")
    assert np.abs(got["o"] - want["o"]).max() < 5e-6
    for name in ("dq", "dk", "dv"):
        assert np.abs(got[name] - want[name]).max() < 5e-5, name


def test_head_sharded_attention_is_not_cp(tmp_path):
    """Heads that divide the model dim shard by head (no offset), with
    MQA's single kv head sliced per rank; output and gradients as without
    a mesh."""
    run_ranks("""
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.parallel.axes import TRAIN_RULES, mesh_context
        mesh = make_test_mesh(2, 2, device_type="cpu")
        g = torch.Generator().manual_seed(0)
        for H, KV in ((4, 2), (4, 1), (6, 3)):
            q0, do0 = (torch.randn(2, 64, H, 16, generator=g) for _ in range(2))
            k0, v0 = (torch.randn(2, 64, KV, 16, generator=g) for _ in range(2))
            rep = [Replicate(), Replicate()]
            q, k, v = (DTensor.from_local(t, mesh, rep).requires_grad_() for t in (q0, k0, v0))
            offsets = []
            local = ops._flash_local
            ops._flash_local = lambda *a: offsets.append(a[-1]) or local(*a)
            with mesh_context(mesh, TRAIN_RULES):
                o = ops.flash_attention(q, k, v, causal=True, window=24)
                (o * DTensor.from_local(do0, mesh, rep)).sum().backward()
            ops._flash_local = local
            assert offsets == [0]
            want = [t.detach().requires_grad_() for t in (q0, k0, v0)]
            wo = ops.flash_attention(*want, causal=True, window=24)
            (wo * do0).sum().backward()
            torch.testing.assert_close(o.full_tensor(), wo, rtol=0, atol=1e-6)
            for t, w in zip((q, k, v), want):
                torch.testing.assert_close(t.grad.full_tensor(), w.grad, rtol=0, atol=1e-5)
        dist.barrier()
        dist.destroy_process_group()
    """, 4, tmp_path)


# (B, Sq, Sk, H, KV, D, causal, window, chunk, softcap, q_offset): a CP
# rank's last rows, a window and a chunk at an offset, no mask at Sq != Sk
# with an offset, a softcap, and rows past every key of their chunk
OFFSET_CASES = [
    (2, 48, 128, 4, 2, 16, True, 0, 0, 0.0, 80),
    (1, 64, 64, 4, 4, 32, True, 16, 0, 0.0, 32),
    (2, 32, 96, 4, 1, 16, True, 0, 16, 0.0, 40),
    (1, 40, 100, 2, 2, 16, False, 0, 0, 0.0, 7),
    (1, 64, 128, 4, 2, 16, True, 0, 0, 20.0, 64),
    (1, 16, 32, 2, 1, 16, True, 0, 16, 0.0, 64),
]


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_flash_at_offset_matches_jax_impl(case):
    B, Sq, Sk, H, KV, D, causal, window, chunk, softcap, off = case
    q, k, v, do = _qkv(B, Sq, Sk, H, KV, D, seed=sum(case[:6]))
    kw = dict(causal=causal, window=window, chunk=chunk, softcap=softcap)
    jo, jlse = jops._flash_fwd_impl(*(jnp.asarray(x) for x in (q, k, v)), causal, window,
                                    chunk, softcap, off, 16, 32)
    jg = jops._flash_bwd_impl(*(jnp.asarray(x) for x in (q, k, v)), jo, jlse, jnp.asarray(do),
                              **kw, q_offset=off, block_q=16, block_k=32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_lse(tq, tk, tv, **kw, q_offset=off)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(B, H, Sq), rtol=1e-6,
                               atol=1e-5)
    grads = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, **kw, q_offset=off)
    for name, a, b in zip(("dq", "dk", "dv"), grads, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=5e-5, err_msg=name)
    # the model's route: ops.flash_attention under autograd (FlashAttention)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, **kw, q_offset=off)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    (out * tdo).sum().backward()
    for name, t, b in zip(("dq", "dk", "dv"), leaves, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), rtol=0, atol=5e-5,
                                   err_msg=name)
    with torch.inference_mode():
        served = ops.flash_attention(tq, tk, tv, **kw, q_offset=off)
    np.testing.assert_allclose(served.numpy(), np.asarray(jo), rtol=0, atol=1e-5)


@pytest.mark.parametrize("off", [0, 5, 64, 200])
def test_tile_class_at_offset_matches_the_mask(off):
    """SKIP exactly when no pair of the tile attends, FULL exactly when every
    pair does (and every key is real), with q row i at position off + i."""
    Sq, Sk, bq, bk = 70, 150, 16, 32
    for causal, window, chunk in itertools.product((True, False), (0, 20), (0, 48)):
        qp = off + torch.arange(Sq)
        m = ref._mask(qp, torch.arange(Sk), causal=causal, window=window, chunk=chunk)
        for q0, k0 in itertools.product(range(0, Sq, bq), range(0, Sk + bk, bk)):
            tile = m[q0:q0 + bq, k0:k0 + bk]
            cls = fa.tile_class(q0, bq, k0, bk, Sq, Sk, causal=causal, window=window,
                                chunk=chunk, q_offset=off)
            if tile.numel() == 0 or not tile.any():
                assert cls == fa.SKIP
            elif tile.all() and k0 + bk <= Sk:
                assert cls == fa.FULL
            else:
                assert cls == fa.PARTIAL


def test_cp_inactive_without_mesh():
    """Outside a mesh context the call takes the kernel route at q_offset 0
    (the plain version on the CPU), at the CP test's shape."""
    q, k, v, _ = _qkv(1, 2048, 2048, 6, 2, 64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    assert ops._maybe_context_parallel(tq, tk, tv, causal=True, window=0, chunk=0,
                                       softcap=0.0, q_offset=0) is None
    got = ops.flash_attention(tq, tk, tv, causal=True)
    want = ref.attention_ref(tq, tk, tv, causal=True)
    assert (got - want).abs().max().item() < 5e-6
    jwant = jax.jit(lambda a, b, c: jops.flash_attention(a, b, c, causal=True))(q, k, v)
    assert np.abs(got.numpy() - np.asarray(jwant)).max() < 5e-6


def test_offset_must_not_be_negative():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, q, q, q_offset=-1)
