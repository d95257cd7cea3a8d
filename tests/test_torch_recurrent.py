"""repro_torch's RWKV-6 block against repro.models.recurrent.rwkv_block on
the same weights and inputs (numpy, seeded), f32, at smoke rwkv6-7b width.

The reference init leaves the LoRA paths at zero (tm_lora_B, wd_B), so the
weights here are drawn for every parameter, zeros included.  Tolerance 1e-5:
the same f32 arithmetic summed in a different order by two frameworks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke
from repro.models import recurrent as jrec
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.models import recurrent as trec

ATOL = 1e-5


def _pair():
    jcfg, tcfg = jsmoke(jget_arch("rwkv6-7b")), smoke_config(get_arch("rwkv6-7b"))
    assert (jcfg.d_model, jcfg.d_ff, jcfg.norm_eps) == (tcfg.d_model, tcfg.d_ff, tcfg.norm_eps)
    assert (tcfg.rwkv.head_dim, tcfg.rwkv.ddlerp_rank, tcfg.rwkv.decay_rank) == (
        jcfg.rwkv.head_dim, jcfg.rwkv.ddlerp_rank, jcfg.rwkv.decay_rank)
    return jcfg, tcfg


def _weights(tcfg, rng):
    """numpy weights for every rwkv parameter, none of them zero: the
    reference's std for "normal" defs, small noise around the rest."""
    out = {}
    for name, d in trec.rwkv_defs(tcfg).items():
        x = rng.standard_normal(d.shape).astype(np.float32)
        if d.init == "ones":
            out[name] = 1.0 + 0.1 * x
        elif d.init == "custom":  # decay logits around the init's span
            out[name] = np.linspace(-6.0, -0.5, d.shape[-1], dtype=np.float32) + 0.3 * x
        elif d.init == "zeros":
            out[name] = 0.1 * x
        else:
            out[name] = x * d.init_scale / np.sqrt(np.prod(d.shape[:-1]))
    return out


@pytest.mark.parametrize("S,with_state", [(16, False), (1, True)])
def test_rwkv_block_matches_jax(S, with_state):
    jcfg, tcfg = _pair()
    rng = np.random.default_rng(S)
    p = _weights(tcfg, rng)
    assert set(p) == set(jrec.rwkv_defs(jcfg))
    B, d = 2, tcfg.d_model
    H, Dh = trec.rwkv_heads(tcfg)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    st = None
    if with_state:
        st = {"S": rng.standard_normal((B, H, Dh, Dh)).astype(np.float32) * 0.3,
              "ts1": rng.standard_normal((B, d)).astype(np.float32),
              "ts2": rng.standard_normal((B, d)).astype(np.float32)}
    want, wst = jrec.rwkv_block({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                jcfg, None if st is None else
                                {k: jnp.asarray(v) for k, v in st.items()})
    tst = None if st is None else {k: torch.tensor(v) for k, v in st.items()}
    got, gst = trec.rwkv_block({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x),
                               tcfg, tst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert set(gst) == set(wst) == {"S", "ts1", "ts2"}
    for name in gst:
        assert gst[name].dtype == torch.float32
        np.testing.assert_allclose(gst[name].numpy(), np.asarray(wst[name]), atol=ATOL)
    if tst is not None:  # the given state is updated in place
        assert all(gst[k] is tst[k] for k in tst)


def test_rwkv_init_state_matches_jax():
    jcfg, tcfg = _pair()
    want = jrec.rwkv_init_state(jcfg, 3)
    got = trec.rwkv_init_state(tcfg, 3)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 and not v.any() for v in got.values())
