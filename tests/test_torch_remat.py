"""The selective remat policies ``dots`` and ``save_attn`` against ``full``,
``none`` and the JAX package's ``jax.grad`` under the same policy.

Cases: smoke rsc-llm (global attention), rwkv6-7b (WKV6 Function, a state
marked dirty), recurrentgemma-9b (RGLRU Function and local attention) and
mixtral-8x22b (the MoE FFN, whose experts' bmm over E is recomputed).  In
f32 on the CPU the loss and every gradient under each policy equal
``full``'s and ``none``'s bits (a saved product is the product the
recompute would make), and ``jax.grad`` of the reference's loss under the
same policy within 1e-5 (loss) and 1e-4 (gradients), as
tests/test_torch_train.py holds them.

Saved tensors: the tensors autograd saves outside the checkpointed layers
(seen by ``saved_tensors_hooks``) are the same under every checkpointing
policy; the selective ones also keep what ``transformer.SAVED`` records:
``save_attn`` one (B * S, d) product per self-attention layer,
``dots`` every product without batch dims a layer makes.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ATTN_KINDS, get_arch, smoke_config
from repro_torch.models import params as pmod
from repro_torch.models import transformer
from tests.conftest import run_subprocess_py

ARCHS = ("rsc-llm", "rwkv6-7b", "recurrentgemma-9b", "mixtral-8x22b")
POLICIES = ("dots", "save_attn")
B, S = 2, 16

JAX_SCRIPT = """
import jax, numpy as np
from repro.checkpoint.manager import _flatten
from repro.configs.base import get_arch, smoke_config
from repro.models import params as pmod, transformer

out = {}
for arch in %(archs)r:
    base = smoke_config(get_arch(arch))
    params = pmod.materialize(transformer.model_defs(base), seed=5)
    tokens = np.random.default_rng(7).integers(3, base.vocab_size, (%(B)d, %(S)d + 1),
                                               dtype=np.int32)
    out[f"{arch}/tokens"] = tokens
    for path, leaf in _flatten(params).items():
        out[f"{arch}/params/{path}"] = np.asarray(leaf)
    for policy in %(policies)r:
        cfg = base.replace(remat_policy=policy)
        loss, grads = jax.value_and_grad(lambda p: transformer.loss_fn(
            p, cfg, {"tokens": jax.numpy.asarray(tokens)})[0])(params)
        out[f"{arch}/{policy}/loss"] = np.asarray(loss)
        for path, leaf in _flatten(grads).items():
            out[f"{arch}/{policy}/grads/{path}"] = np.asarray(leaf)
np.savez(%(path)r, **out)
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_remat") / "ref.npz")
    r = run_subprocess_py(JAX_SCRIPT % {"archs": ARCHS, "policies": POLICIES, "B": B, "S": S,
                                        "path": path},
                          env_extra={"REPRO_COMPUTE_DTYPE": "float32", "JAX_PLATFORMS": "cpu"},
                          timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(data, arch, policy, hooks=None):
    """(loss, grads in param order, saved outside the layers, SAVED)."""
    cfg = smoke_config(get_arch(arch)).replace(remat_policy=policy)
    params = {k[len(f"{arch}/params/"):]: torch.from_numpy(v).requires_grad_()
              for k, v in data.items() if k.startswith(f"{arch}/params/")}
    batch = {"tokens": torch.from_numpy(data[f"{arch}/tokens"]).long()}
    seen = []
    transformer.SAVED.clear()
    with torch.autograd.graph.saved_tensors_hooks(lambda t: (seen.append(t.shape), t)[1],
                                                  lambda t: t):
        loss, _ = transformer.loss_fn(params, cfg, batch, dtype=torch.float32)
    saved = list(transformer.SAVED)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads)), seen, saved


@pytest.mark.parametrize("arch", ARCHS)
def test_policies_give_full_and_none_bits(jax_run, arch):
    runs = {p: _run(jax_run, arch, p) for p in ("none", "full") + POLICIES}
    for policy in POLICIES:
        for base in ("full", "none"):
            assert torch.equal(runs[policy][0], runs[base][0]), (policy, base)
            for path, g in runs[policy][1].items():
                assert torch.equal(g, runs[base][1][path]), (policy, base, path)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_policies_match_jax_grad(jax_run, arch, policy):
    loss, grads, _, _ = _run(jax_run, arch, policy)
    np.testing.assert_allclose(loss.numpy(), jax_run[f"{arch}/{policy}/loss"], atol=1e-5)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jax_run[f"{arch}/{policy}/grads/{path}"],
                                   atol=1e-4, err_msg=path)


class _Products(TorchDispatchMode):
    """Counts the products without batch dims made inside ``apply_layer``."""

    def __init__(self):
        super().__init__()
        self.inside, self.count = False, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.inside and (func in transformer._DOTS or (
                func is transformer._BMM and args[0].shape[0] == 1)):
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_each_policy_saves_what_it_names(jax_run, arch, monkeypatch):
    cfg = smoke_config(get_arch(arch))
    full = _run(jax_run, arch, "full")
    for policy in POLICIES:
        _, _, seen, saved = _run(jax_run, arch, policy)
        assert seen == full[2], policy  # outside the layers: as under "full"
        if policy == "save_attn":
            n_attn = cfg.count_kind(*ATTN_KINDS)
            assert saved == [((B * S, cfg.d_model), torch.float32)] * n_attn
    assert full[3] == []
    # dots: every product a layer makes without batch dims, counted by a
    # dispatch mode over the layers of a run without remat
    products = _Products()
    apply = transformer.apply_layer

    def counted(*args, **kwargs):
        products.inside = True
        try:
            return apply(*args, **kwargs)
        finally:
            products.inside = False

    monkeypatch.setattr(transformer, "apply_layer", counted)
    params = pmod.materialize(transformer.model_defs(cfg), seed=0)
    tokens = torch.from_numpy(jax_run[f"{arch}/tokens"]).long()
    with torch.no_grad(), products:
        transformer.loss_fn(params, cfg.replace(remat_policy="none"), {"tokens": tokens},
                            dtype=torch.float32)
    monkeypatch.undo()
    saved = _run(jax_run, arch, "dots")[3]
    assert len(saved) == products.count > 0
    assert all(dtype == torch.float32 and shape[0] in (1, B * S) for shape, dtype in saved)
