"""repro_torch's sharding rules against the JAX package's: ``ShardingRules.spec``
and ``spec_for`` for the three rule tables over every logical-axis tuple the
reference's parameters and ``constrain`` calls use, on (2, 4) and (2, 2, 2)
meshes; ``ParamDef.axes`` path by path for all eleven architectures; the
turn of a spec into DTensor placements.

The reference's ``spec_for`` reads only ``mesh.shape``, so a stand-in whose
``shape`` is a dict runs both packages' in this process, without devices.
"""
import itertools
import pathlib
import re
import types

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.checkpoint.manager import _flatten as jflatten
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import list_archs
from repro.models import transformer as jtransformer
from repro.parallel import axes as jaxes
from repro_torch.configs.base import get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.models import params as pmod
from repro_torch.models import transformer
from repro_torch.parallel import axes as taxes

ROOT = pathlib.Path(__file__).resolve().parents[1]
RULES = ("TRAIN_RULES", "SERVE_RULES", "LONG_CONTEXT_RULES")
MESHES = {"2x4": {"data": 2, "model": 4}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}


def _constrain_axes() -> set:
    """The logical-axis tuples of every ``constrain(x, ...)`` call in the
    reference's model code, read from its source."""
    out = set()
    for path in (ROOT / "src" / "repro" / "models").glob("*.py"):
        for call in re.findall(r"constrain\(\s*[^,()]+(?:\([^()]*\))?[^,()]*,([^)]*)\)",
                               path.read_text()):
            items = [a.strip() for a in call.split(",") if a.strip()]
            if items and all(a == "None" or re.fullmatch(r'"\w+"', a) for a in items):
                out.add(tuple(None if a == "None" else a.strip('"') for a in items))
    return out


def _param_axes() -> set:
    return {tuple(d.axes) for arch in list_archs()
            for d in jflatten(jtransformer.model_defs(jget_arch(arch))).values()}


CONSTRAIN_AXES = sorted(_constrain_axes(), key=str)
ALL_AXES = sorted(_constrain_axes() | _param_axes(), key=str)


def test_constrain_sites_were_found():
    # the residual stream, attention, the FFN, MoE and RG-LRU sites
    for axes in (("act_batch", "act_res_seq", None), ("act_batch", "act_seq", "act_heads", None),
                 ("act_batch", "act_seq", "act_ff"), ("act_batch", "act_experts", None, "act_ff"),
                 ("act_batch", "act_seq", "act_lru"), ("act_batch", "act_seq", "act_vocab")):
        assert axes in CONSTRAIN_AXES
    assert len(ALL_AXES) > len(CONSTRAIN_AXES)


def test_rule_tables_are_copies():
    for name in RULES:
        assert getattr(taxes, name).rules == getattr(jaxes, name).rules


@pytest.mark.parametrize("rules", RULES)
def test_spec_matches_reference(rules):
    for axes in ALL_AXES:
        want = getattr(jaxes, rules).spec(axes)
        got = getattr(taxes, rules).spec(axes)
        assert tuple(got) == tuple(want), (rules, axes)
    r = taxes.ShardingRules({"a": "model", "b": "model"})
    assert tuple(r.spec(("a", "b"))) == ("model",)
    over = taxes.TRAIN_RULES.with_overrides(cache_seq="model")
    assert over.rules["cache_seq"] == "model" and taxes.TRAIN_RULES.rules["cache_seq"] is None


@pytest.mark.parametrize("rules,mesh", list(itertools.product(RULES, MESHES)))
def test_spec_for_matches_reference(rules, mesh):
    """Shapes drawn from sizes that do and do not divide the mesh dims
    (MQA's one kv head, seamless's 256206 vocab), and each architecture's
    parameter shapes."""
    stand_in = types.SimpleNamespace(shape=MESHES[mesh])
    jr, tr = getattr(jaxes, rules), getattr(taxes, rules)
    rng = np.random.default_rng(7)
    sizes = (1, 2, 3, 4, 6, 8, 12, 16, 24, 56, 128, 2048, 256206)
    cases = [(tuple(int(rng.choice(sizes)) for _ in axes), axes)
             for axes in ALL_AXES for _ in range(12)]
    cases += [(d.shape, tuple(d.axes)) for arch in list_archs()
              for d in jflatten(jtransformer.model_defs(jget_arch(arch))).values()]
    for shape, axes in cases:
        jd, td = [], []
        want = jaxes.spec_for(shape, axes, stand_in, jr, jd)
        got = taxes.spec_for(shape, axes, stand_in, tr, td)
        assert tuple(got) == tuple(want), (shape, axes)
        assert td == jd, (shape, axes)


def test_spec_for_drops_what_does_not_divide():
    stand_in = types.SimpleNamespace(shape={"data": 2, "model": 4})
    dropped = []
    s = taxes.spec_for((1024, 1, 128), ("embed", "kv_heads", "head_dim"), stand_in,
                       taxes.TRAIN_RULES, dropped)
    assert tuple(s) == ("data",) and dropped == [("kv_heads", "model", 1)]
    s = taxes.spec_for((256206, 1024), ("vocab", "embed"), stand_in, taxes.TRAIN_RULES)
    assert tuple(s) == (None, "data")


def test_param_axes_match_reference():
    """Every ParamDef of all eleven architectures carries the reference's
    axes, path by path, so both packages shard alike."""
    assert len(list_archs()) == 11
    for arch in list_archs():
        want = jflatten(jtransformer.model_defs(jget_arch(arch)))
        got = dict(pmod.flatten(transformer.model_defs(get_arch(arch))))
        assert list(got) == list(want), arch
        for path, d in got.items():
            assert d.axes is not None and len(d.axes) == len(d.shape), (arch, path)
            assert tuple(d.axes) == tuple(want[path].axes), (arch, path)


def test_placements_follow_the_spec():
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2})
    assert taxes.placements(taxes.Spec(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert taxes.placements(taxes.Spec(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert taxes.placements(taxes.Spec(), mesh) == (Replicate(),) * 3


def test_out_of_order_tuple_raises():
    """DTensor splits a tensor dim over mesh dims in mesh order; a tuple
    entry listed otherwise must raise, not permute the shards quietly."""
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2})
    with pytest.raises(ValueError, match="mesh order"):
        taxes.placements(taxes.Spec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        taxes.placements(taxes.Spec("stage"), mesh)


def test_shardings_per_path():
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4})
    defs = transformer.model_defs(get_arch("rsc-llm"))
    dropped = []
    sh = pmod.shardings(defs, mesh, taxes.TRAIN_RULES, dropped)
    assert sh["groups/0/p0/attn/wq"] == (Shard(1), Shard(2))  # (layers, embed, heads, dh)
    assert sh["embed"] == (Shard(1), Shard(0))  # (vocab over model, embed over data)
    assert sh["ln_f"] == (Shard(0), Replicate())
    assert dropped == []
    with pytest.raises(TypeError, match="axes"):  # required, as the reference's
        pmod.ParamDef((4, 4))
    with pytest.raises(ValueError, match="do not match shape"):
        pmod.ParamDef((4, 4), ("embed",))


def test_constrain_is_an_identity_off_a_mesh():
    x = torch.arange(12.0).reshape(3, 4)
    assert taxes.constrain(x, "act_batch", None) is x
    assert torch.equal(taxes.constrain_view(x, (3, 2, 2), "act_batch", "act_heads", None),
                       x.view(3, 2, 2))
    with taxes.mesh_context(types.SimpleNamespace(shape={"data": 2}), taxes.TRAIN_RULES):
        assert taxes.constrain(x, "act_batch", None) is x  # a plain tensor
        assert taxes.current_rules() is taxes.TRAIN_RULES
    assert taxes.current_mesh() is None and taxes.current_rules() is None


def test_mesh_constants_and_no_process_group_on_import():
    assert tmesh.SINGLE_POD == (16, 16) and tmesh.MULTI_POD == (2, 16, 16)
    assert tmesh.device_count_required("single") == 256
    assert tmesh.device_count_required("multi") == 512
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="single|multi"):
        tmesh.make_mesh_named("triple")
