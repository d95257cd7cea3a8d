"""repro_torch's MoE FFN against repro.models.layers.moe_ffn on the same
weights and inputs (numpy, seeded), f32.

Smoke mixtral-8x22b (4 experts, top-2) and smoke llama4-scout-17b-a16e (4
experts, top-1, a shared expert), both with groups of 64 tokens: as
configured, with no drops (capacity factor 2.0 for top-2 and 4.0 for top-1
give C >= G), with forced drops (capacity factor 0.5), with a group size that
does not divide the tokens into 64s, and at the decode shape (T = B).
Tolerances: the output within 1e-5 (the same f32 arithmetic summed in a
different order by two frameworks), the aux to 1e-6 relative, the dropped
fraction exactly; the gradients of sum(out * w) + lb + z to 1e-5.  The
reference runs op by op (``jax.disable_jit``), as ``jax.value_and_grad`` of
its loss runs in tests/test_torch_train.py: under ``jax.jit`` XLA fuses its
``1 - kept / slots`` into one FMA with a rounded reciprocal, which reads
-5.2e-8 when nothing drops (test_jit_reference_rounds_the_dropped_fraction).

The kept set is read off the outputs: each expert's w_down writes only its
own block of d_model, so block e of a token's output is exactly zero when
and only when no kept slot sends the token to expert e (the reference's
combine sums only zeros there, and the port's gathers a zero row).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke
from repro.models import layers as jl
from repro_torch.configs.base import MoESpec, get_arch, smoke_config
from repro_torch.models import layers as tl

ATOL = 1e-5
AUX_RTOL = 1e-6
ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e")
# name -> (arch, MoESpec overrides, (B, S))
CASES = {
    "mixtral": ("mixtral-8x22b", {}, (2, 64)),
    "mixtral-no-drops": ("mixtral-8x22b", {"capacity_factor": 2.0}, (2, 64)),
    "mixtral-drops": ("mixtral-8x22b", {"capacity_factor": 0.5}, (2, 64)),
    "mixtral-ragged-groups": ("mixtral-8x22b", {}, (3, 40)),  # G = 60
    "mixtral-decode": ("mixtral-8x22b", {}, (4, 1)),
    "llama4": ("llama4-scout-17b-a16e", {}, (2, 64)),
    "llama4-no-drops": ("llama4-scout-17b-a16e", {"capacity_factor": 4.0}, (2, 64)),
    "llama4-drops": ("llama4-scout-17b-a16e", {"capacity_factor": 0.5}, (2, 64)),
    "llama4-decode": ("llama4-scout-17b-a16e", {}, (4, 1)),
}
AUX = ("moe_lb_loss", "moe_z_loss")


def _pair(arch, **moe):
    """The same smoke config, with the same MoESpec overrides, from both
    packages."""
    jcfg, tcfg = jsmoke(jget_arch(arch)), smoke_config(get_arch(arch))
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe))
    assert dataclasses.asdict(jcfg.moe) == dataclasses.asdict(tcfg.moe)
    assert (jcfg.d_model, jcfg.d_ff) == (tcfg.d_model, tcfg.d_ff)
    return jcfg, tcfg


def _flat(defs, prefix=""):
    out = {}
    for k, v in defs.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat):
    out = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def _weights(cfg, rng, *, zero_router=False, blocks=False, no_shared=False):
    """numpy weights for the MoE defs: every matrix N(0, 1 / fan-in), so
    router logits and outputs are of order 1 for x ~ N(0, 1); ``blocks``
    confines expert e's output to block e of d_model."""
    p = {k: rng.standard_normal(d.shape).astype(np.float32) * d.shape[-2] ** -0.5
         for k, d in _flat(tl.moe_defs(cfg)).items()}
    if zero_router:
        p["router"][:] = 0.0
    if blocks:
        E, _, d = p["w_down"].shape
        width = d // E
        for e in range(E):
            keep = np.zeros(d, bool)
            keep[e * width:(e + 1) * width] = True
            p["w_down"][e][:, ~keep] = 0.0
    if no_shared:
        p = {k: (np.zeros_like(v) if k.startswith("shared/") else v) for k, v in p.items()}
    return p


def _run_both(name, p, x):
    arch, over, _ = CASES[name]
    jcfg, tcfg = _pair(arch, **over)
    got, gaux = tl.moe_ffn(_nest({k: torch.from_numpy(v) for k, v in p.items()}),
                           torch.from_numpy(x), tcfg)
    with jax.disable_jit():
        want, waux = jl.moe_ffn(_nest({k: jnp.asarray(v) for k, v in p.items()}),
                                jnp.asarray(x), jcfg)
    return tcfg, (got, gaux), (np.asarray(want), {k: np.asarray(v) for k, v in waux.items()})


def _x(cfg, shape, rng):
    B, S = shape
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _kept(out, E):
    """(tokens, E) bool: which experts' blocks of each token's output are
    not exactly zero."""
    T, d = out.reshape(-1, out.shape[-1]).shape
    return (out.reshape(T, E, d // E) != 0).any(-1)


def test_moe_spec_defaults_match_the_reference():
    from repro.configs.base import MoESpec as JMoESpec

    spec, jspec = MoESpec(n_experts=8, top_k=2), JMoESpec(n_experts=8, top_k=2)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert spec.router_z_loss == 1e-3 and spec.load_balance_loss == 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_defs_match_the_reference(arch):
    jcfg, tcfg = _pair(arch)
    jd, td = _flat(jl.moe_defs(jcfg)), _flat(tl.moe_defs(tcfg))
    assert list(sorted(jd)) == list(sorted(td))
    for k in td:
        assert (td[k].shape, td[k].init, td[k].init_scale) == (
            jd[k].shape, jd[k].init, jd[k].init_scale), k
    assert td["router"].init_scale == 0.1
    assert ("shared/w_up" in td) == (arch == "llama4-scout-17b-a16e")


@pytest.mark.parametrize("group", [1, 4, 60, 64, 1024, 1000])
@pytest.mark.parametrize("spec", [dict(n_experts=8, top_k=2, capacity_factor=1.25),
                                  dict(n_experts=16, top_k=1, capacity_factor=2.0),
                                  dict(n_experts=4, top_k=2, capacity_factor=0.5)])
def test_capacity_matches_the_reference(spec, group):
    from repro.configs.base import MoESpec as JMoESpec

    got = tl._capacity(MoESpec(**spec), group)
    assert got == jl._capacity(JMoESpec(**spec), group)
    assert got >= 4 and got % 4 == 0


def test_full_width_capacities():
    """The full-width prefill (B 4, S 2048: groups of 1024) and decode
    (T = G = 4) capacities."""
    assert tl._capacity(get_arch("mixtral-8x22b").moe, 1024) == 320
    assert tl._capacity(get_arch("llama4-scout-17b-a16e").moe, 1024) == 128
    for arch in ARCHS:
        assert tl._capacity(get_arch(arch).moe, 4) == 4


@pytest.mark.parametrize("name", CASES)
def test_moe_ffn_matches_jax(name):
    _, _, shape = CASES[name]
    rng = np.random.default_rng(0)
    tcfg = _pair(CASES[name][0])[1]
    p = _weights(tcfg, rng)
    x = _x(tcfg, shape, rng)
    tcfg, (got, gaux), (want, waux) = _run_both(name, p, x)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert set(gaux) == set(waux)
    for k in AUX:
        np.testing.assert_allclose(gaux[k].numpy(), waux[k], rtol=AUX_RTOL, err_msg=k)
    assert float(gaux["moe_dropped_frac"]) == float(waux["moe_dropped_frac"])
    if "no-drops" in name or "decode" in name:
        assert float(gaux["moe_dropped_frac"]) == 0.0
    if name.endswith("-drops") and "no-drops" not in name:
        assert float(gaux["moe_dropped_frac"]) > 0.3


@pytest.mark.parametrize("name", ["mixtral", "mixtral-drops", "mixtral-ragged-groups",
                                  "llama4", "llama4-drops"])
def test_moe_keeps_the_reference_slots(name):
    """Which (token, expert) pairs survive capacity, exactly: the drops
    follow the running count over the group's (token, k) slots."""
    _, _, shape = CASES[name]
    rng = np.random.default_rng(1)
    tcfg = _pair(CASES[name][0])[1]
    p = _weights(tcfg, rng, blocks=True, no_shared=True)
    x = _x(tcfg, shape, rng)
    tcfg, (got, gaux), (want, waux) = _run_both(name, p, x)
    E, K = tcfg.moe.n_experts, tcfg.moe.top_k
    kept_got, kept_want = _kept(got.numpy(), E), _kept(want, E)
    np.testing.assert_array_equal(kept_got, kept_want)
    T = x.shape[0] * x.shape[1]
    assert kept_want.sum() == round((1.0 - float(waux["moe_dropped_frac"])) * T * K)
    assert float(gaux["moe_dropped_frac"]) == float(waux["moe_dropped_frac"])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_picks_the_lower_experts(arch):
    """An all-zero router ties every expert: the reference's lax.top_k
    takes experts 0..K-1, and so must the port (torch.topk would not);
    each expert keeps the first C tokens of each group."""
    name = "mixtral" if arch == "mixtral-8x22b" else "llama4"
    rng = np.random.default_rng(2)
    tcfg = _pair(arch)[1]
    p = _weights(tcfg, rng, zero_router=True, blocks=True, no_shared=True)
    x = _x(tcfg, (2, 64), rng)
    tcfg, (got, gaux), (want, waux) = _run_both(name, p, x)
    E, K = tcfg.moe.n_experts, tcfg.moe.top_k
    G = tcfg.moe.group_size
    C = tl._capacity(tcfg.moe, G)
    expect = np.zeros((x.shape[0] * x.shape[1], E), bool)
    expect[(np.arange(len(expect)) % G) < C, :K] = True
    np.testing.assert_array_equal(_kept(want, E), expect)
    np.testing.assert_array_equal(_kept(got.numpy(), E), expect)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert float(gaux["moe_dropped_frac"]) == float(waux["moe_dropped_frac"]) == 1.0 - C / G
    np.testing.assert_allclose(gaux["moe_lb_loss"].numpy(), waux["moe_lb_loss"], rtol=AUX_RTOL)


def test_torch_topk_alone_orders_ties_otherwise():
    """Why the port sorts: on equal probabilities torch.topk need not pick
    the lower experts, a stable descending sort does, and so does
    lax.top_k."""
    probs = torch.full((3, 8), 0.125)
    picked = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :2]
    assert picked.tolist() == [[0, 1]] * 3
    assert np.asarray(jax.lax.top_k(jnp.full((3, 8), 0.125), 2)[1]).tolist() == [[0, 1]] * 3


@pytest.mark.parametrize("name", ["mixtral", "mixtral-drops", "llama4", "llama4-drops"])
def test_moe_ffn_gradients_match_jax(name):
    """d/d(x, every weight) of sum(out * w) + lb + z, against jax.grad."""
    arch, over, shape = CASES[name]
    jcfg, tcfg = _pair(arch, **over)
    rng = np.random.default_rng(3)
    p = _weights(tcfg, rng)
    x = _x(tcfg, shape, rng)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(pp, xx):
        out, aux = jl.moe_ffn(pp, xx, jcfg)
        return (out * w).sum() + aux["moe_lb_loss"] + aux["moe_z_loss"]

    jp = _nest({k: jnp.asarray(v) for k, v in p.items()})
    with jax.disable_jit():
        want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    want = dict(_flat(want_p), x=want_x)

    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tl.moe_ffn(_nest(tp), tx, tcfg)
    loss = (out * torch.from_numpy(w)).sum() + aux["moe_lb_loss"] + aux["moe_z_loss"]
    grads = torch.autograd.grad(loss, list(tp.values()) + [tx])
    got = dict(zip(list(tp) + ["x"], grads))
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)


def test_moe_ffn_in_bf16_stays_near_the_reference():
    """In bf16 (the serving dtype; the gates rounded to bf16 before the
    combine, as the reference casts its combine weights) the port keeps the
    reference's slots, and its output is no farther from the f32 result on
    the same bf16 inputs than the reference's bf16 output is (the two round
    their expert products in different places; the f32 result is the
    port's, which the cases above hold to the reference's to 1e-5); the
    two differ by a few bf16 roundings (rms within 2^-6 of the output's)."""
    jcfg, tcfg = _pair("mixtral-8x22b")
    rng = np.random.default_rng(4)
    p = _weights(tcfg, rng, blocks=True)
    x = _x(tcfg, (2, 64), rng)
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in p.items()}
    tx = torch.from_numpy(x).bfloat16()
    got, gaux = tl.moe_ffn(_nest(tp), tx, tcfg)
    f32, _ = tl.moe_ffn(_nest({k: v.float() for k, v in tp.items()}), tx.float(), tcfg)
    want, waux = jax.jit(jl.moe_ffn, static_argnums=(2,))(
        _nest({k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}),
        jnp.asarray(x, jnp.bfloat16), jcfg)
    assert got.dtype == torch.bfloat16
    got, want, f32 = got.float().numpy(), np.asarray(want, np.float32), f32.numpy()
    E = tcfg.moe.n_experts
    np.testing.assert_array_equal(_kept(got, E), _kept(want, E))
    assert np.abs(got - f32).max() <= np.abs(want - f32).max()
    assert np.sqrt(((got - want) ** 2).mean()) <= 2.0 ** -6 * np.sqrt((want ** 2).mean())
    np.testing.assert_allclose(float(gaux["moe_dropped_frac"]),
                               float(waux["moe_dropped_frac"]), atol=1e-7)


def test_jit_reference_rounds_the_dropped_fraction():
    """A record of the reference's arithmetic, not the port's: under jax.jit
    XLA computes 1 - kept / slots as one FMA with the rounded reciprocal of
    slots, so with nothing dropped at 240 slots (groups of 60, top-2) it
    reads -5.2e-8; op by op, and in the port, it is 0 exactly."""
    name = "mixtral-ragged-groups"
    arch, over, shape = CASES[name]
    jcfg, tcfg = _pair(arch, capacity_factor=4.0)
    rng = np.random.default_rng(5)
    p = _weights(tcfg, rng)
    x = _x(tcfg, shape, rng)
    _, gaux = tl.moe_ffn(_nest({k: torch.from_numpy(v) for k, v in p.items()}),
                         torch.from_numpy(x), tcfg)
    jp = _nest({k: jnp.asarray(v) for k, v in p.items()})
    _, jit_aux = jax.jit(jl.moe_ffn, static_argnums=(2,))(jp, jnp.asarray(x), jcfg)
    with jax.disable_jit():
        _, eager_aux = jl.moe_ffn(jp, jnp.asarray(x), jcfg)
    assert float(gaux["moe_dropped_frac"]) == float(eager_aux["moe_dropped_frac"]) == 0.0
    assert float(jit_aux["moe_dropped_frac"]) == pytest.approx(-5.2154064e-08, rel=1e-6)
