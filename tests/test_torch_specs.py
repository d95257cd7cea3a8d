"""repro_torch's ``launch.specs`` against the JAX package's, for every
registered architecture and every assigned shape: each step argument's
shape and dtype (the reference's ``ShapeDtypeStruct``), with and without
``REPRO_OPT8BIT=1``; each input's and output's placements against the
reference's ``PartitionSpec`` under the same rules, on small meshes and on
the production ones; ``transformer.init_cache`` and ``cache_axes`` against
the reference's trees.

The reference's ``spec_for`` reads only ``mesh.shape``, so a stand-in mesh
whose ``shape`` is a dict runs both packages here, without devices; the
reference's ``NamedSharding`` is replaced by its spec for the comparison.
"""
import types

import jax
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import list_archs
from repro.launch import specs as jspecs
from repro.models import params as jparams
from repro.models import transformer as jtransformer
from repro_torch.configs.base import SHAPES, get_arch
from repro_torch.launch import specs
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.parallel.axes import Spec, placements

MESHES = {"2x4": {"data": 2, "model": 4}, "2x2x2": {"pod": 2, "data": 2, "model": 2},
          "single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


def _key(p) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)


def _jflat(tree) -> dict:
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    return {"/".join(_key(p) for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]}


def _flat(tree, prefix="") -> dict:
    """Path -> leaf of a port tree: dicts by key, lists and AdamWState by
    position / field; a tensor or a tuple of placements is a leaf."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, adamw.AdamWState):
        return {k: v for f in tree._fields
                for k, v in _flat(getattr(tree, f), f"{prefix}{f}/").items()}
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree
                                  and not hasattr(tree[0], "is_shard")):
        return {k: v for i, t in enumerate(tree) for k, v in _flat(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


@pytest.fixture
def spec_only(monkeypatch):
    """The reference's sharding helpers with NamedSharding replaced by its
    spec."""
    for mod in (jspecs, jparams):
        monkeypatch.setattr(mod, "NamedSharding", lambda mesh, spec: spec)


CELLS = [(a, s) for a in list_archs() for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(monkeypatch, arch, shape):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for opt8 in ("0", "1"):
        monkeypatch.setenv("REPRO_OPT8BIT", opt8)
        want = _jflat(jspecs.input_specs(jcfg, JSHAPES[shape]))
        got = _flat(specs.input_specs(cfg, SHAPES[shape]))
        assert sorted(got) == sorted(want), (opt8, set(got) ^ set(want))
        for path, t in got.items():
            assert t.device.type == "meta", path
            assert (tuple(t.shape), _dtype(t)) == (tuple(want[path].shape),
                                                    str(want[path].dtype)), (opt8, path)
        if opt8 == "1" and SHAPES[shape].kind == "train":
            assert any(p.endswith("/q") for p in got) and any(p.endswith("/s") for p in got)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_placements_match_reference(monkeypatch, spec_only, arch, shape):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    monkeypatch.setenv("REPRO_OPT8BIT", "1" if arch in ("qwen3-0.6b", "mixtral-8x22b") else "0")
    for sizes in MESHES.values():
        mesh = types.SimpleNamespace(shape=dict(sizes))
        for side in ("input", "output"):
            dropped, jdropped = [], []
            if side == "input":
                got = specs.input_shardings(cfg, SHAPES[shape], mesh, dropped=dropped)
                want = jspecs.input_shardings(jcfg, JSHAPES[shape], mesh, dropped=jdropped)
            else:
                got = specs.output_shardings(cfg, SHAPES[shape], mesh)
                want = jspecs.output_shardings(jcfg, JSHAPES[shape], mesh)
            got, want = _flat(got), _jflat(want)
            assert sorted(got) == sorted(want), (sizes, side, set(got) ^ set(want))
            for path, pl in got.items():
                assert pl == placements(Spec(*want[path]), mesh), (sizes, side, path)
            assert sorted(dropped) == sorted(jdropped)


@pytest.mark.parametrize("arch", list_archs())
def test_init_cache_and_axes_match_reference(arch):
    """The cache template: the reference's tree, shapes and dtypes (bf16
    keys and values, f32 states, an int32 position), on any device; its
    axes tree equal to the reference's; the prefill's cache in its layout."""
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    assert transformer.cache_axes(cfg) == jtransformer.cache_axes(jcfg)
    want = _jflat(jax.eval_shape(lambda: jtransformer.init_cache(jcfg, 3, 40, 24)))
    got = _flat(transformer.init_cache(cfg, 3, 40, 24, device="meta"))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert (tuple(t.shape), _dtype(t)) == (tuple(want[path].shape), str(want[path].dtype))


def test_prefill_cache_has_the_template_layout():
    """A smoke prefill's cache holds init_cache's tensors, shape for shape
    (the position an int there, the template's an int32 scalar)."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.models.steps import make_prefill_step
    from repro_torch.models.transformer import Transformer

    for arch in ("recurrentgemma-9b", "rwkv6-7b", "seamless-m4t-large-v2"):
        cfg = smoke_config(get_arch(arch))
        model = Transformer(cfg, device="cpu", dtype=torch.float32)
        batch = {"tokens": torch.randint(3, cfg.vocab_size, (2, 64))}
        if cfg.enc_dec:
            batch["frames"] = torch.randn(2, 24, cfg.d_model)
        _, cache = make_prefill_step(model)(batch)
        tmpl = transformer.init_cache(cfg, 2, 64, 24, dtype=torch.float32, device="meta")
        got, want = _flat(cache["groups"]), _flat(tmpl["groups"])
        assert sorted(got) == sorted(want)
        assert all(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype for k in got)
        assert cache["pos"] == 64 and tmpl["pos"].dtype == torch.int32


def test_rules_and_enc_len_match_reference():
    for name in SHAPES:
        assert specs.rules_for(SHAPES[name]).rules == jspecs.rules_for(JSHAPES[name]).rules
    cfg, jcfg = get_arch("seamless-m4t-large-v2"), jget_arch("seamless-m4t-large-v2")
    assert specs.enc_len(cfg, 32768) == jspecs.enc_len(jcfg, 32768)
