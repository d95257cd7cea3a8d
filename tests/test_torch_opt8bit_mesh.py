"""The 8-bit AdamW state on a DeviceMesh: ``adamw.init_8bit`` and
``adamw.apply_8bit`` (donated and not) on DTensor leaves of a 2 x 2
("data", "model") gloo mesh of 4 CPU ranks under TRAIN_RULES.

The leaves cover both of the update's paths: last axes whose shards hold
whole quantization blocks (the unsharded update on each rank's shards, no
communication; scales sharded like the codes, or the last axis unsplit) and
last axes whose blocks span ranks (768 split into 384 = 1.5 blocks of 256,
misaligned; 128 into 64, half a block; the block maxima all-reduced), in
f32 and bf16, a last axis of blocks of 1, and a leaf under QUANT_MIN_SIZE
(f32 moments).

- ``init_8bit`` places every moment as ``launch/specs.py`` does (the codes
  and the f32 moments as their parameter, the scales by ``spec_for`` on
  the scales' shape), and no rank holds a moment of the global shape.
- Two steps, each from the mesh run's own state before it (gathered),
  against two oracles:
  * the port's 8-bit step without a mesh.  With a gradient clip that does
    not bind the update is elementwise and the blocks' maxima exact, so
    params, codes and scales equal it to the bit.  With a clip that binds,
    the global norm is summed in another order (shards, then an
    all-reduce), so the clip scale may differ by float rounding: each
    weight within 1e-6 plus lr times the most its update moves when its
    gradient moves by SCALE_RTOL relative, the scales SCALE_RTOL relative,
    each code within half a code unit of the oracle's unrounded value (its
    new moment over its new scale) plus what that gradient moves it, in
    code units (``tests/test_torch_opt8bit.py``'s rule).
  * the JAX package's ``adamw.apply_8bit`` under ``jax.jit`` on a 2 x 2
    mesh of forced host devices, its state placed by the reference's
    ``_opt_moment_shardings`` rule, on the same numpy inputs: the same
    tolerances, and an f32 moment two f32 units more (XLA may contract a
    product and a sum into one rounding).
- Donated and out of place give the same bits on the mesh.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.optim import adamw
from tests.test_torch_parallel import run_jax, run_ranks

# name: (shape, logical axes, dtype)
LEAVES = {
    "emb": ((64, 768), ("vocab", "embed"), "float32"),    # 384 a shard: blocks span ranks
    "w_in": ((512, 128), ("embed", "ff"), "float32"),     # 64 a shard: half a block
    "w_h": ((64, 768), ("embed", "ff"), "bfloat16"),      # bf16, blocks span ranks
    "w_out": ((64, 1024), ("embed", "ff"), "float32"),    # 512 a shard: whole blocks
    "stack": ((2, 16, 512), ("layers", "embed", "ff"), "float32"),  # whole blocks, 3-d
    "tall": ((128, 256), ("embed", None), "float32"),     # last axis unsplit
    "odd": ((2, 4099), ("embed", None), "float32"),       # blocks of 1
    "small": ((8, 16), ("embed", "ff"), "float32"),       # under QUANT_MIN_SIZE: f32 moments
}
SPANNING = ("emb", "w_in", "w_h")
LR = 1e-2
CLIPS = {"free": 100.0, "binding": 1e-3}  # a gradient clip that does not bind, one that does
SCALE_RTOL = 1e-6  # the clip scale's relative difference from another summation order


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, (s, _, _) in
              LEAVES.items()}
    grads = [{k: (rng.standard_normal(s) * 2e-3).astype(np.float32) for k, (s, _, _) in
              LEAVES.items()} for _ in range(2)]
    return params, grads


def _cfg(clip):
    return adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10, grad_clip=clip)


RANK_SCRIPT = """
    import json
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel.axes import TRAIN_RULES, placements, spec_for
    LEAVES, CLIPS, LR = %(leaves)r, %(clips)r, %(lr)r
    mesh = make_test_mesh(2, 2, device_type="cpu")
    inp = np.load(os.path.join(OUT, "inputs.npz"))
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def place(x, shape, axes):
        return distribute_tensor(x, mesh, placements(spec_for(shape, axes, mesh, TRAIN_RULES),
                                                     mesh), src_data_rank=None)

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def dump(prefix, params, state, out):
        out[prefix + "step"] = np.asarray(int(state.step))
        for k, p in params.items():
            out[prefix + "p/" + k] = full(p).float().numpy()
            for mom in ("m", "v"):
                e = getattr(state, mom)[k]
                if isinstance(e, dict):
                    out[prefix + mom + "/" + k + "/q"] = full(e["q"]).numpy()
                    out[prefix + mom + "/" + k + "/s"] = full(e["s"]).numpy()
                else:
                    out[prefix + mom + "/" + k] = full(e).numpy()

    params0 = {k: place(torch.from_numpy(inp["p/" + k]).to(dt[d]), s, a)
               for k, (s, a, d) in LEAVES.items()}
    state0 = adamw.init_8bit(params0)
    # every moment placed as launch/specs.py places it, each rank its shard
    placed = {}
    for k, (s, a, _) in LEAVES.items():
        for mom in ("m", "v"):
            e = getattr(state0, mom)[k]
            if isinstance(e, dict):
                s_shape = tuple(s[:-1]) + (s[-1] // adamw._opt_block(s[-1]),)
                want_s = placements(spec_for(s_shape, a, mesh, TRAIN_RULES), mesh)
                ok = (tuple(e["q"].placements) == tuple(params0[k].placements)
                      and tuple(e["s"].placements) == tuple(want_s)
                      and e["q"].to_local().shape == params0[k].to_local().shape
                      and tuple(e["s"].to_local().shape) != tuple(s_shape)
                      and e["q"].dtype == torch.int8 and e["s"].dtype == torch.float32)
            else:
                ok = (tuple(e.placements) == tuple(params0[k].placements)
                      and e.to_local().shape == params0[k].to_local().shape)
            placed[mom + "/" + k] = bool(ok and tuple(full(e["q"] if isinstance(e, dict) else e)
                                                      .shape) == tuple(s)
                                         and tuple((e["q"] if isinstance(e, dict) else e)
                                                   .to_local().shape) != tuple(s))
    out = {}
    dump("init/", params0, state0, out)
    for clip_name, clip in CLIPS.items():
        cfg = adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10, grad_clip=clip)
        for donate in (False, True):
            params = {k: place(torch.from_numpy(inp["p/" + k]).to(dt[d]), s, a)
                      for k, (s, a, d) in LEAVES.items()}
            state = adamw.init_8bit(params)
            for i in range(2):
                grads = {k: place(torch.from_numpy(inp[f"g{i}/" + k]), s, a)
                         for k, (s, a, _) in LEAVES.items()}
                tag = f"{clip_name}/{int(donate)}/{i}/"
                dump(tag + "pre/", params, state, out)
                ptrs = [params[k].to_local().data_ptr() for k in params]
                adamw.sharded_updates.update(local=0, spanning=0)
                params, state, met = adamw.apply_8bit(cfg, params, state, grads, donate=donate)
                # the three SPANNING leaves through the all-reduced path, the rest local
                assert adamw.sharded_updates == {"local": len(LEAVES) - 3, "spanning": 3}, \
                    adamw.sharded_updates
                if donate:
                    assert [params[k].to_local().data_ptr() for k in params] == ptrs
                for k in params:
                    assert tuple(params[k].placements) == tuple(grads[k].placements)
                dump(tag + "post/", params, state, out)
    if RANK == 0:
        np.savez(os.path.join(OUT, "mesh.npz"), **out)
        with open(os.path.join(OUT, "placed.json"), "w") as f:
            json.dump(placed, f)
    dist.barrier()
    dist.destroy_process_group()
"""

JAX_SCRIPT = """
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro.launch.mesh import compat_make_mesh
    from repro.optim import adamw
    from repro.parallel.axes import TRAIN_RULES, spec_for
    LEAVES, CLIPS, LR, OUT = %(leaves)r, %(clips)r, %(lr)r, %(out)r
    mesh = compat_make_mesh((2, 2), ("data", "model"))
    got = np.load(OUT + "/mesh.npz")
    dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    out = {}

    def sh(shape, axes):
        return NamedSharding(mesh, spec_for(shape, axes, mesh, TRAIN_RULES))

    for clip_name, clip in CLIPS.items():
        cfg = adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10, grad_clip=clip)
        step_fn = jax.jit(lambda p, s, g: adamw.apply_8bit(cfg, p, s, g)[:2])
        for i in range(2):
            pre = f"{clip_name}/0/{i}/pre/"
            params, grads, m, v = {}, {}, {}, {}
            for k, (s, a, d) in LEAVES.items():
                params[k] = jax.device_put(jnp.asarray(got[pre + "p/" + k], dt[d]), sh(s, a))
                grads[k] = jax.device_put(jnp.asarray(np.load(OUT + "/inputs.npz")[f"g{i}/" + k]),
                                          sh(s, a))
                for mom, tree in (("m", m), ("v", v)):
                    key = pre + mom + "/" + k
                    if key + "/q" in got.files:
                        s_shape = tuple(s[:-1]) + (s[-1] // adamw._opt_block(s[-1]),)
                        tree[k] = {"q": jax.device_put(jnp.asarray(got[key + "/q"]), sh(s, a)),
                                   "s": jax.device_put(jnp.asarray(got[key + "/s"]),
                                                       sh(s_shape, a))}
                    else:
                        tree[k] = jax.device_put(jnp.asarray(got[key]), sh(s, a))
            state = adamw.AdamWState(step=jnp.asarray(int(got[pre + "step"]), jnp.int32), m=m, v=v)
            new_p, new_s = step_fn(params, state, grads)
            post = f"{clip_name}/{i}/"
            for k in LEAVES:
                out[post + "p/" + k] = np.asarray(new_p[k].astype(jnp.float32))
                for mom in ("m", "v"):
                    e = getattr(new_s, mom)[k]
                    if isinstance(e, dict):
                        out[post + mom + "/" + k + "/q"] = np.asarray(e["q"])
                        out[post + mom + "/" + k + "/s"] = np.asarray(e["s"])
                    else:
                        out[post + mom + "/" + k] = np.asarray(e)
    np.savez(OUT + "/jax.npz", **out)
    print("OK")
"""


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("opt8mesh")
    params, grads = _inputs()
    np.savez(tmp / "inputs.npz", **{"p/" + k: v for k, v in params.items()},
             **{f"g{i}/" + k: v for i, g in enumerate(grads) for k, v in g.items()})
    fmt = {"leaves": LEAVES, "clips": CLIPS, "lr": LR}
    run_ranks(RANK_SCRIPT % fmt, 4, tmp)
    run_jax(JAX_SCRIPT % dict(fmt, out=str(tmp)), 4)
    with np.load(tmp / "mesh.npz") as f:
        mesh = {k: f[k] for k in f.files}
    with np.load(tmp / "jax.npz") as f:
        ref = {k: f[k] for k in f.files}
    placed = json.loads((tmp / "placed.json").read_text())
    return mesh, ref, placed


def _state(d: dict, prefix: str) -> tuple[dict, adamw.AdamWState]:
    """(params, state) of ``d``'s arrays under ``prefix``, as plain tensors."""
    params, m, v = {}, {}, {}
    for k, (_, _, dtype) in LEAVES.items():
        params[k] = torch.from_numpy(d[prefix + "p/" + k]).to(getattr(torch, dtype))
        for mom, tree in (("m", m), ("v", v)):
            key = prefix + mom + "/" + k
            tree[k] = ({"q": torch.from_numpy(d[key + "/q"]), "s": torch.from_numpy(d[key + "/s"])}
                       if key + "/q" in d else torch.from_numpy(d[key]))
    return params, adamw.AdamWState(torch.tensor(int(d[prefix + "step"]), dtype=torch.int32),
                                    m, v)


def _grads(i):
    return {k: torch.from_numpy(v) for k, v in _inputs()[1][i].items()}


def _terms(cfg, old_m, old_v, g, step):
    """(m_n, v_n, the update before lr and weight decay) in f64."""
    b1c, b2c = 1.0 - cfg.b1 ** step, 1.0 - cfg.b2 ** step
    m_n = cfg.b1 * old_m + (1.0 - cfg.b1) * g
    v_n = cfg.b2 * old_v + (1.0 - cfg.b2) * g * g
    return m_n, v_n, (m_n / b1c) / (torch.sqrt(v_n / b2c) + cfg.eps)


def _spread(f, g, d):
    at = f(g)
    return torch.maximum((f(g + d) - at).abs(), (f(g - d) - at).abs())


def _hold(cfg, pre: dict, prefix_pre: str, got: dict, prefix_got: str, want: dict,
          prefix_want: str, grads: dict) -> dict:
    """``got``'s step against ``want``'s from the same state: every weight,
    scale and code within the tolerances of the module docstring.  Returns
    {leaf: codes unequal}."""
    params, state = _state(pre, prefix_pre)
    step = float(int(state.step) + 1)
    gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values()))
    scale = float(torch.clamp(cfg.grad_clip / gnorm.clamp(min=1e-9), max=1.0))
    lr = float(adamw.schedule(cfg, torch.tensor(int(step), dtype=torch.int32)))
    flipped = {}
    for k in LEAVES:
        old = {mom: getattr(state, mom)[k] for mom in ("m", "v")}
        old = {mom: (adamw._dq8(e) if isinstance(e, dict) else e).double()
               for mom, e in old.items()}
        g = grads[k].double() * scale
        d = SCALE_RTOL * g.abs()

        def term(j, gg, old=old):
            return _terms(cfg, old["m"], old["v"], gg, step)[j]

        tol = 1e-6 + lr * _spread(lambda gg: term(2, gg), g, d)
        err = (torch.from_numpy(got[prefix_got + "p/" + k]).double()
               - torch.from_numpy(want[prefix_want + "p/" + k]).double()).abs()
        if LEAVES[k][2] == "bfloat16":  # a weight rounded to bf16: one unit either way
            tol = tol + torch.from_numpy(want[prefix_want + "p/" + k]).double().abs() * 2.0 ** -7
        assert bool((err <= tol).all()), (prefix_got, k, float((err - tol).max()))
        flipped[k] = 0
        for j, mom in enumerate(("m", "v")):
            key_g, key_w = prefix_got + mom + "/" + k, prefix_want + mom + "/" + k
            if key_g in got:  # f32 moments
                gm, wm = (torch.from_numpy(x[y]).double() for x, y in ((got, key_g),
                                                                       (want, key_w)))
                # plus two f32 units: XLA may round m_n once where torch rounds thrice
                assert bool(((gm - wm).abs() <= _spread(lambda gg: term(j, gg), g, d)
                             + 2.0 ** -22 * wm.abs() + 1e-12).all()), key_g
                continue
            ws = torch.from_numpy(want[key_w + "/s"])
            np.testing.assert_allclose(got[key_g + "/s"], want[key_w + "/s"], rtol=SCALE_RTOL,
                                       atol=SCALE_RTOL * float(ws.abs().max()), err_msg=key_g)
            blocks = (*ws.shape, -1)
            units = term(j, g).reshape(blocks) / ws.double()[..., None]
            moved = (_spread(lambda gg: term(j, gg), g, d).reshape(blocks)
                     / ws.double()[..., None]) + SCALE_RTOL * units.abs()
            q = torch.from_numpy(got[key_g + "/q"]).double().reshape(blocks)
            assert bool(((q - units).abs() <= 0.5 + moved + 1e-9).all()), key_g
            flipped[k] += int((got[key_g + "/q"] != want[key_w + "/q"]).sum())
    return flipped


def test_init_places_every_moment_as_specs_does(ran):
    _, _, placed = ran
    assert placed and all(placed.values()), {k: v for k, v in placed.items() if not v}
    assert len(placed) == 2 * len(LEAVES)


def test_init_equals_the_unsharded_init(ran):
    mesh, _, _ = ran
    host = {k: torch.zeros(s) for k, (s, _, _) in LEAVES.items()}
    want = adamw.init_8bit(host)
    for k in LEAVES:
        for mom in ("m", "v"):
            e = getattr(want, mom)[k]
            key = f"init/{mom}/{k}"
            if isinstance(e, dict):
                assert np.array_equal(mesh[key + "/q"], e["q"].numpy())
                assert np.array_equal(mesh[key + "/s"], e["s"].numpy())
            else:
                assert np.array_equal(mesh[key], e.numpy())


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("clip", list(CLIPS))
def test_mesh_step_against_the_unsharded_step(ran, clip, step):
    """The mesh run's step against the port's step without a mesh from the
    same (gathered) state: to the bit where the clip does not bind, else
    within the reduction-order tolerances; donated and out of place alike."""
    mesh, _, _ = ran
    cfg = _cfg(CLIPS[clip])
    grads = _grads(step)
    for donate in (0, 1):
        tag = f"{clip}/{donate}/{step}/"
        params, state = _state(mesh, tag + "pre/")
        new_p, new_s, _ = adamw.apply_8bit(cfg, params, state, grads)
        want = {}
        for k in LEAVES:
            want["p/" + k] = new_p[k].float().numpy()
            for mom in ("m", "v"):
                e = getattr(new_s, mom)[k]
                if isinstance(e, dict):
                    want[f"{mom}/{k}/q"], want[f"{mom}/{k}/s"] = e["q"].numpy(), e["s"].numpy()
                else:
                    want[f"{mom}/{k}"] = e.numpy()
        if clip == "free":
            for key, w in want.items():
                assert np.array_equal(mesh[tag + "post/" + key], w), (tag, key)
        else:
            flipped = _hold(cfg, mesh, tag + "pre/", mesh, tag + "post/", want, "", grads)
            print(f"{tag}: codes unequal to the unsharded step's {flipped}")
            n = sum(LEAVES[k][0][0] * int(np.prod(LEAVES[k][0][1:])) for k in flipped)
            assert sum(flipped.values()) <= 1e-3 * n, flipped


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("clip", list(CLIPS))
def test_mesh_step_against_the_jax_package(ran, clip, step):
    """The mesh run's step against the JAX package's ``apply_8bit`` on its
    own 2 x 2 mesh, from the same state on the same gradients."""
    mesh, ref, _ = ran
    tag = f"{clip}/0/{step}/"
    flipped = _hold(_cfg(CLIPS[clip]), mesh, tag + "pre/", mesh, tag + "post/", ref,
                    f"{clip}/{step}/", _grads(step))
    print(f"{tag}: codes unequal to the JAX package's {flipped}")
    n = sum(int(np.prod(LEAVES[k][0])) for k in flipped)
    assert sum(flipped.values()) <= 1e-3 * n, flipped


@pytest.mark.parametrize("clip", list(CLIPS))
def test_donated_equals_out_of_place_on_the_mesh(ran, clip):
    mesh, _, _ = ran
    keys = [k for k in mesh if k.startswith(f"{clip}/0/")]
    assert keys
    for k in keys:
        assert np.array_equal(mesh[k], mesh[k.replace(f"{clip}/0/", f"{clip}/1/", 1)]), k


def test_spanning_leaves_span_ranks():
    """The leaves named SPANNING do split a block across the 2-way mesh dim
    (so the all-reduced path runs), the others hold whole blocks."""
    for k, (shape, axes, _) in LEAVES.items():
        if np.prod(shape) < adamw.QUANT_MIN_SIZE:
            continue
        split = 2 if axes[-1] in ("embed", "ff", "vocab") else 1
        spans = (shape[-1] // split) % adamw._opt_block(shape[-1]) != 0
        assert spans == (k in SPANNING), k


TRAIN_SCRIPT = """
    import json
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import get_arch, smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import params as pmod, transformer
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.parallel.axes import TRAIN_RULES, mesh_context, placements_for
    from repro_torch.runtime import elastic
    cfg = smoke_config(get_arch("rsc-llm"))
    defs = transformer.model_defs(cfg)
    os.environ["REPRO_OPT8BIT"] = "1"
    step = make_train_step(cfg, adamw.AdamWConfig(lr=1e-2, warmup_steps=1), dtype=torch.float32)
    mesh = make_test_mesh(2, 2, device_type="cpu")
    ckpt = CheckpointManager(os.path.join(OUT, "ckpt"))
    out = {"opt8bit": step.opt8bit}

    def batch(seed):
        t = torch.from_numpy(np.random.default_rng(seed).integers(3, cfg.vocab_size, (4, 33)))
        return {"tokens": distribute_tensor(
            t, mesh, placements_for(t.shape, ("act_batch", None), mesh, TRAIN_RULES),
            src_data_rank=None)}

    def flat(params, state):
        tree = {"p/" + k: v for k, v in elastic.host_tree(params).items()}
        for mom in ("m", "v"):
            for k, e in elastic.host_tree(getattr(state, mom)).items():
                for sub, t in (e.items() if isinstance(e, dict) else [("", e)]):
                    tree[f"{mom}/{k}/{sub}"] = t
        return tree

    def pl(state):
        return {f"{mom}/{k}/{sub}": tuple(t.placements) for mom in ("m", "v")
                for k, e in getattr(state, mom).items()
                for sub, t in (e.items() if isinstance(e, dict) else [("", e)])}

    with mesh_context(mesh, TRAIN_RULES):
        params = elastic.reshard_for(pmod.materialize(defs, seed=0), mesh, TRAIN_RULES, defs)
        adamw.sharded_updates.update(local=0, spanning=0)
        p1, s1, _ = step(params, adamw.init_8bit(params), batch(1))
        out["paths"] = dict(adamw.sharded_updates)
        saved = (elastic.host_tree(p1), adamw.AdamWState(
            s1.step, elastic.host_tree(s1.m), elastic.host_tree(s1.v)))
        if RANK == 0:
            ckpt.save(1, saved)
        dist.barrier()
        p2, s2, m2 = step(p1, s1, batch(2))  # the run that was not interrupted
        cont = flat(p2, s2)
        # a new attempt: restore into an init_8bit template, place on the mesh
        host = pmod.materialize(defs, seed=0)
        at, (rp, rs), _ = ckpt.restore((host, adamw.init_8bit(host)))
        rp = elastic.reshard_for(rp, mesh, TRAIN_RULES, defs)
        rs = elastic.reshard_state_for(rs, mesh, TRAIN_RULES, defs)
        out["placed_as_init"] = pl(rs) == pl(adamw.init_8bit(rp))
        out["restored_bits"] = all(torch.equal(a, b) for a, b in zip(
            flat(rp, rs).values(), flat(p1, s1).values()))
        p3, s3, m3 = step(rp, rs, batch(2))
        resumed = flat(p3, s3)
        out["resumed_bits"] = (all(torch.equal(resumed[k], cont[k]) for k in cont)
                               and torch.equal(m3["loss"].full_tensor(), m2["loss"].full_tensor()))
        out["n_leaves"] = len(cont)
    if RANK == 0:
        manifest = json.load(open(os.path.join(OUT, "ckpt", "step_000000001", "manifest.json")))
        out["dtypes"] = manifest["dtypes"]
        with open(os.path.join(OUT, "train.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
"""


def test_8bit_train_step_on_a_mesh_resumes_from_a_checkpoint(tmp_path):
    """The 8-bit train step of smoke rsc-llm on the 2 x 2 mesh (its blocks
    span ranks on the embedding's split last axis), its state saved by
    CheckpointManager in the reference's on-disk form (flatten paths under
    ``1/.m/`` and ``1/.v/``: int8 ``q``, f32 ``s``), restored into an
    ``init_8bit`` template and placed by ``elastic.reshard_state_for``: the
    placements ``init_8bit`` gives, the saved bits, and a next step equal to
    the uninterrupted run's to the bit."""
    run_ranks(TRAIN_SCRIPT, 4, tmp_path)
    out = json.loads((tmp_path / "train.json").read_text())
    assert out["opt8bit"] and out["paths"]["spanning"] > 0 and out["paths"]["local"] > 0
    assert out["placed_as_init"] and out["restored_bits"] and out["resumed_bits"]
    dtypes = out["dtypes"]
    codes = [k for k in dtypes if k.startswith("1/.m/") and k.endswith("/q")]
    assert codes and all(dtypes[k] == "int8" for k in codes)
    assert all(dtypes[k[:-2] + "/s"] == "float32" for k in codes)
    assert any(k.startswith("1/.m/groups/0/") for k in codes), sorted(dtypes)[:8]


class _Mesh:
    """A production mesh's dim sizes, as specs.py and scale_placements read
    them (no process group)."""

    def __init__(self, **sizes):
        self.shape = sizes

    def size(self, i):
        return list(self.shape.values())[i]


@pytest.mark.parametrize("mesh", [_Mesh(data=16, model=16), _Mesh(pod=2, data=16, model=16)],
                         ids=["single", "multi"])
def test_scale_placements_equal_specs_for_every_arch(monkeypatch, mesh):
    """``adamw.scale_placements`` of each quantized leaf's placements (what
    ``init_8bit`` and ``elastic.reshard_state_for`` use) equals the
    placements ``launch/specs.py`` gives its scales (the reference's rule on
    the scales' shape), for every architecture's full-width train defs on
    both production meshes; among them leaves whose blocks span ranks."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import params as pmod
    from repro_torch.parallel.axes import TRAIN_RULES

    monkeypatch.setenv("REPRO_OPT8BIT", "1")
    spans = 0
    for arch in dryrun.ASSIGNED:
        defs = specs.train_defs(get_arch(arch))
        want = specs._moment_placements(defs, mesh, TRAIN_RULES)
        p_pl = pmod.shardings(defs, mesh, TRAIN_RULES)
        for path, d in pmod.flatten(defs):
            if not isinstance(want[path], dict):
                continue
            assert want[path]["q"] == p_pl[path], (arch, path)
            got = adamw.scale_placements(d.shape, p_pl[path], mesh)
            assert got == want[path]["s"], (arch, path, got, want[path]["s"])
            split = [mesh.size(i) for i, p in enumerate(p_pl[path])
                     if adamw._splits_last(p, len(d.shape))]
            spans += bool(split) and (d.shape[-1] // np.prod(split)) % adamw._opt_block(
                d.shape[-1]) != 0
    assert spans > 0
