"""The 8-bit AdamW state (``REPRO_OPT8BIT=1``) through repro_torch's
trainer, on the CPU.

- ``adamw.apply_8bit(donate=True)`` writes into the tensors it was given,
  a slice of whole quantization blocks at a time, and equals the
  out-of-place update to the bit over several steps: leaves under
  ``QUANT_MIN_SIZE`` (f32 moments), a last axis whose block falls to 64,
  an odd last axis (blocks of 1), and slice bounds that cut a leaf into
  many slices.  From zero moments its first step equals ``adamw.apply``'s
  to the bit (the update reads the moments before they are requantized).
- The port's 8-bit trainer on smoke rsc-llm and smoke llama4-scout-17b-a16e
  (chunked layers, the MoE FFN), through a crash and a restore, held step
  by step against the JAX package's ``make_train_step`` under
  ``REPRO_OPT8BIT=1``: each executed step's state before it is written as a
  checkpoint (the reference's on-disk form), restored by the reference's
  manager into an ``init_8bit`` template, stepped there on the same batch,
  and compared with the port's state after the step.  Tolerances: the
  port's gradients within 1e-4 of the reference's (GRAD_TOL,
  ``tests/test_torch_train.py``'s); each stepped weight within 1e-6 plus
  lr times the most the 8-bit update moves when its gradient moves by
  GRAD_TOL (step 1 gives ``test_train_step_matches_jax``'s bound; later
  steps divide by the dequantized second moment, which can be small);
  the block scales 1e-6 relative (``test_adamw_8bit_step_matches_jax``);
  each int8 code within half a code unit of the reference's unrounded
  value, its new moment over its new scale, plus what that gradient moves
  it.  Codes are not all equal across the two frameworks: a value near a
  rounding boundary lands on either side of it when the gradients (or the
  global norm, summed in another order) differ by float rounding, which
  moved 22 of 1,556,480 codes on rsc-llm and 38 of 3,522,560 on
  llama4-scout by one (the test prints its counts under ``pytest -s``).
  Within the port the codes are equal to the bit: donated or not, and a
  replayed step.
- The crashed run's final state equals the clean run's to the bit, codes
  and scales included; the 8-bit state round-trips ``CheckpointManager``
  to the bit, sync and async, also when the donated update overwrites it
  while the async write is still running; the launcher trains under
  ``REPRO_OPT8BIT=1``.
- ``chip_smoke.py``'s llama4-scout-17b-a16e cell: its cut, the bytes of the
  8-bit state it writes, and the disk route they take.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager as manager_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.models import params as pmod
from repro_torch.models import transformer
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw
from repro_torch.runtime.fault_injection import FaultInjector, InjectedFault
from repro_torch.runtime.train_loop import FaultTolerantTrainer, TrainerConfig, optimizer_config
from tests.conftest import run_subprocess_py

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

RTOL = 1e-6
GRAD_TOL = 1e-4  # tests/test_torch_train.py's, on every gradient


@pytest.fixture(autouse=True)
def _one_thread():
    """Test workers share the CPU: one intra-op thread each keeps torch's
    thread pools from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def opt8(monkeypatch):
    monkeypatch.setenv("REPRO_OPT8BIT", "1")


def _leaves(seed=0):
    """f32 leaves: two quantized with 256-wide blocks, one whose block
    falls to 64 (last axis 192), one of blocks of 1 (last axis 4099), a
    3-d stack, and two under QUANT_MIN_SIZE; and a quantized bf16 leaf."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 256), "e": (2, 4, 16, 256), "n": (40, 192), "odd": (4099,),
              "b": (8,), "s": (3, 96)}
    out = {k: torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32))
           for k, s in shapes.items()}
    out["h"] = (out["w"] * 0.5).to(torch.bfloat16)
    return out


def _grads(params, i):
    return {k: torch.cos(v.float() * (3 + i) + i * 0.1) * 0.05 for k, v in params.items()}


def _state_tensors(state):
    return [t for tree in (state.m, state.v) for e in tree.values()
            for t in (e.values() if isinstance(e, dict) else (e,))]


def _assert_equal_states(a, b):
    assert int(a.step) == int(b.step)
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_leaves_cover_each_kind_of_leaf():
    state = adamw.init_8bit(_leaves())
    quant = {k for k, m in state.m.items() if isinstance(m, dict)}
    assert quant == {"w", "e", "n", "odd", "h"}
    assert state.m["n"]["s"].shape == (40, 3)  # 64-wide blocks
    assert state.m["odd"]["s"].shape == (4099,)  # blocks of 1
    assert adamw._opt_block(192) == 64 and adamw._opt_block(4099) == 1


@pytest.mark.parametrize("clip", [1.0, 1e-3])
@pytest.mark.parametrize("slice_elements", [adamw.SLICE_ELEMENTS, 512, 64])
def test_donated_8bit_update_equals_out_of_place_to_the_bit(monkeypatch, clip,
                                                            slice_elements):
    """Three steps of ``apply_8bit(donate=True)`` against ``donate=False``:
    the same params, codes and scales to the bit, written into the tensors
    given (no new tensor returned).  A bound of 512 elements cuts the
    (2, 4, 16, 256) stack into 16 slices of 2 blocks; a bound of 64, every
    leaf of 64- or 256-wide blocks into slices of one block."""
    monkeypatch.setattr(adamw, "SLICE_ELEMENTS", slice_elements)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=clip)
    p = _leaves()
    fp, fs = dict(p), adamw.init_8bit(p)
    dp, ds = {k: v.clone() for k, v in p.items()}, adamw.init_8bit(p)
    for i in range(3):
        g = _grads(fp, i)
        fp, fs, fm = adamw.apply_8bit(cfg, fp, fs, g)
        ptrs = [t.data_ptr() for t in (*dp.values(), *_state_tensors(ds))]
        dp, ds, dm = adamw.apply_8bit(cfg, dp, ds, g, donate=True)
        assert [t.data_ptr() for t in (*dp.values(), *_state_tensors(ds))] == ptrs
        for k in p:
            assert fp[k].dtype == dp[k].dtype and torch.equal(fp[k], dp[k]), k
        _assert_equal_states(fs, ds)
        assert torch.equal(fm["grad_norm"], dm["grad_norm"]) and int(ds.step) == i + 1
    assert any(bool((e["q"] != 0).any()) for e in fs.m.values() if isinstance(e, dict))


def test_slices_keep_blocks_whole_within_the_bound(monkeypatch):
    monkeypatch.setattr(adamw, "SLICE_ELEMENTS", 1000)
    p = torch.zeros(6, 4, 192)
    state = adamw.init_8bit({"p": p})
    cuts = list(adamw._block_slices(p, p, state.m["p"], state.v["p"]))
    assert [c[0].shape for c in cuts] == [(15, 64)] * 4 + [(12, 64)]
    for ps, gs, ms, vs in cuts:
        assert ps.numel() <= 1000 and ms["q"].shape == ps.shape and ms["s"].shape == (len(ps), 1)
        assert ps.data_ptr() >= p.data_ptr()  # a view of the leaf
    small = adamw.init_8bit({"b": torch.zeros(8)})
    assert len(list(adamw._block_slices(torch.zeros(8), torch.zeros(8), small.m["b"],
                                        small.v["b"]))) == 1


def test_global_norm_sums_a_large_leaf_in_slices(monkeypatch):
    """A leaf over SLICE_ELEMENTS is squared and summed a slice at a time:
    the same norm to f32 rounding, the same bits at or under the bound."""
    rng = np.random.default_rng(5)
    tree = {"a": torch.from_numpy(rng.standard_normal((37, 50)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(300).astype(np.float32))}
    whole = adamw.global_norm(tree)
    want = np.sqrt(sum((v.double() ** 2).sum().item() for v in tree.values()))
    monkeypatch.setattr(adamw, "SLICE_ELEMENTS", 300)
    assert torch.equal(adamw.global_norm({"b": tree["b"]}),
                       torch.sqrt(torch.sum(torch.square(tree["b"]))))
    sliced = adamw.global_norm(tree)  # "a" in 7 slices
    assert abs(float(sliced) - want) <= 1e-6 * want and abs(float(whole) - want) <= 1e-6 * want


@pytest.mark.parametrize("donate", [False, True])
def test_first_8bit_step_equals_the_f32_step_to_the_bit(donate):
    """From zero moments the 8-bit update reads m_n and v_n before they are
    requantized, so its first step's params are AdamW's to the bit."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    p = _leaves(seed=3)
    g = _grads(p, 0)
    want, _, _ = adamw.apply(cfg, dict(p), adamw.init(p), g)
    given = {k: v.clone() for k, v in p.items()}
    got, _, _ = adamw.apply_8bit(cfg, given, adamw.init_8bit(p), g, donate=donate)
    for k in p:
        assert torch.equal(got[k], want[k]), k


def test_the_step_says_which_state_it_takes(monkeypatch):
    cfg = smoke_config(get_arch("rsc-llm"))
    monkeypatch.setenv("REPRO_OPT8BIT", "1")
    assert make_train_step(cfg, adamw.AdamWConfig()).opt8bit
    monkeypatch.setenv("REPRO_OPT8BIT", "0")
    assert not make_train_step(cfg, adamw.AdamWConfig()).opt8bit


def _trainer(cfg, ckpt_dir, *, steps=4, schedule=None, ckpt_async=False, seed=7,
             dtype=torch.float32):
    tcfg = TrainerConfig(total_steps=steps, global_batch=2, seq_len=32, ckpt_dir=str(ckpt_dir),
                         ckpt_every_steps=2, ckpt_async=ckpt_async, n_nodes=4, seed=seed)
    return FaultTolerantTrainer(cfg, tcfg, FaultInjector(schedule=schedule or {}), device="cpu",
                                dtype=dtype)


def _final_state(cfg, ckpt_dir):
    p0 = {k: torch.empty(d.shape, dtype=d.dtype, device="meta")
          for k, d in pmod.flatten(transformer.model_defs(cfg))}
    _, tree, _ = CheckpointManager(ckpt_dir).restore((p0, adamw.init_8bit(p0)))
    return tree


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, adamw.AdamWState):
        return adamw.AdamWState(*(_clone(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


# name -> (arch, config overrides): llama4-scout's chunk cut to 16 < S
CASES = {"rsc-llm": ("rsc-llm", {}),
         "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", {"window": 16})}
CRASH = 3  # the crash before step 4: steps 3 and 4 run after the restore from step 2


def _cfg(name):
    arch, over = CASES[name]
    return smoke_config(get_arch(arch)).replace(**over)


JAX_SCRIPT = textwrap.dedent("""
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.manager import CheckpointManager, _flatten
    from repro.configs.base import get_arch, smoke_config
    from repro.models import params as pmod, transformer
    from repro.models.steps import make_train_step
    from repro.optim import adamw

    out = {}
    for name, (arch, over, n) in %(cases)r.items():
        cfg = smoke_config(get_arch(arch)).replace(**over)
        tmpl = jax.eval_shape(lambda: pmod.materialize(transformer.model_defs(cfg), seed=0))
        step = jax.jit(make_train_step(cfg, adamw.AdamWConfig(**%(opt)r)))
        grad = jax.jit(jax.grad(lambda p, b: transformer.loss_fn(p, cfg, b)[0]))
        for i in range(n):
            d = "%(root)s/" + name + "/" + str(i)
            _, (p, s), _ = CheckpointManager(d).restore((tmpl, jax.eval_shape(adamw.init_8bit, tmpl)))
            batch = {"tokens": jnp.asarray(np.load(d + "/tokens.npy"))}
            p1, s1, m = step(p, s, batch)
            for tag, tree in (("after", (p1, s1)), ("grads", grad(p, batch))):
                for path, leaf in _flatten(tree).items():
                    out[f"{name}/{i}/{tag}/{path}"] = np.asarray(leaf)
            out[f"{name}/{i}/loss"] = np.asarray(m["loss"])
    np.savez("%(root)s/ref.npz", **out)
""")


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """Each case trained by the port's 8-bit trainer through a crash and a
    restore, each executed step's state before and after it; the same
    steps taken by the reference from the state before."""
    root = tmp_path_factory.mktemp("opt8")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    os.environ["REPRO_OPT8BIT"] = "1"
    runs = {}
    try:
        for name in CASES:
            tr = _trainer(_cfg(name), root / "ck" / name,
                          schedule={CRASH: InjectedFault("gpu_memory_errors", node_id=0)})
            step_fn, records = tr.step_fn, []

            def recorded(params, opt_state, batch, step_fn=step_fn, records=records):
                before = _clone((params, opt_state))  # the step updates them in place
                out = step_fn(params, opt_state, batch)
                records.append((before, batch["tokens"].clone(), _clone(out[:2]),
                                float(out[2]["loss"])))
                return out

            tr.step_fn = recorded
            rep = tr.run()
            for i, (before, tokens, _, _) in enumerate(records):
                d = root / name / str(i)
                CheckpointManager(d).save(int(before[1].step), before)
                np.save(d / "tokens.npy", tokens.numpy().astype(np.int32))
            runs[name] = (tr, rep, records)
    finally:
        os.environ.pop("REPRO_OPT8BIT")
        torch.set_num_threads(n)
    tr = next(iter(runs.values()))[0]
    opt = {f: getattr(optimizer_config(tr.tcfg), f) for f in ("lr", "warmup_steps",
                                                              "total_steps")}
    cases = {name: (*CASES[name], len(runs[name][2])) for name in CASES}
    r = run_subprocess_py(JAX_SCRIPT % {"cases": cases, "opt": opt, "root": root},
                          env_extra={"REPRO_COMPUTE_DTYPE": "float32", "JAX_PLATFORMS": "cpu",
                                     "REPRO_OPT8BIT": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(root / "ref.npz") as data:
        ref = {k: torch.from_numpy(data[k]) for k in data.files}
    return runs, ref


def _moments_and_delta(opt_cfg, m, v, g, b1c, b2c):
    """(m_n, v_n, the update before lr and weight decay) of the 8-bit
    AdamW step at the gradient ``g`` (clipped), in f64."""
    m_n = opt_cfg.b1 * m + (1.0 - opt_cfg.b1) * g
    v_n = opt_cfg.b2 * v + (1.0 - opt_cfg.b2) * g * g
    return m_n, v_n, (m_n / b1c) / (torch.sqrt(v_n / b2c) + opt_cfg.eps)


def _spread(f, g, d):
    """The most ``f`` moves when its gradient moves by ``d`` either way."""
    at = f(g)
    return torch.maximum((f(g + d) - at).abs(), (f(g - d) - at).abs())


@pytest.mark.parametrize("name", CASES)
def test_8bit_trainer_matches_the_reference_step_by_step(stepped, name):
    """Each executed step of the port's trainer against the reference's
    step from the same state on the same batch.  The port's gradients lie
    within GRAD_TOL of the reference's; each stepped weight, moment and
    code lies within what a gradient that far from the reference's moves
    it: the weight by lr times the most the update moves (plus 1e-6), a
    code by at most half a code unit past the reference's unrounded value
    (its new moment over its new scale) plus what the moment moves, in
    code units."""
    from repro_torch.models.steps import loss_and_grads

    runs, ref = stepped
    tr, rep, records = runs[name]
    # steps 1, 2, 3, then the crash; restored from step 2: 3 and 4 again
    assert rep.final_step == 4 and [a.start_step for a in rep.attempts] == [0, 2]
    assert [int(r[0][1].step) for r in records] == [0, 1, 2, 2, 3]
    opt_cfg = optimizer_config(tr.tcfg)
    codes = [0, 0]  # codes unequal to the reference's, codes
    for i, ((p0, s0), tokens, (params, state), loss) in enumerate(records):
        pre = f"{name}/{i}/"
        np.testing.assert_allclose(loss, float(ref[pre + "loss"]), atol=1e-5)
        assert int(state.step) == int(ref[pre + "after/1/.step"]) == int(s0.step) + 1
        grads = {k[len(pre) + 6:]: v.double() for k, v in ref.items()
                 if k.startswith(pre + "grads/")}
        _, _, ours = loss_and_grads(_cfg(name), p0, {"tokens": tokens.long()},
                                    dtype=torch.float32)
        for path, g in ours.items():
            np.testing.assert_allclose(g.numpy(), grads[path].numpy(), atol=GRAD_TOL,
                                       err_msg=path)
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = float(torch.clamp(opt_cfg.grad_clip / gnorm.clamp(min=1e-9), max=1.0))
        step = state.step.double()
        b1c, b2c = 1.0 - opt_cfg.b1 ** step, 1.0 - opt_cfg.b2 ** step
        lr = float(adamw.schedule(opt_cfg, state.step))
        d = GRAD_TOL * scale
        for path, p in params.items():
            old = {mom: getattr(s0, mom)[path] for mom in ("m", "v")}
            old = {mom: (adamw._dq8(e) if isinstance(e, dict) else e).double()
                   for mom, e in old.items()}
            g = grads[path] * scale

            def term(j, gg, old=old):
                return _moments_and_delta(opt_cfg, old["m"], old["v"], gg, b1c, b2c)[j]

            tol = 1e-6 + lr * _spread(lambda gg: term(2, gg), g, d)
            err = (p.double() - ref[f"{pre}after/0/{path}"].double()).abs()
            assert bool((err <= tol).all()), (i, path, float((err - tol).max()))
            for j, mom in enumerate(("m", "v")):
                ent, key = getattr(state, mom)[path], f"{pre}after/1/.{mom}/{path}"
                if not isinstance(ent, dict):
                    want = ref[key].double()
                    assert bool(((ent.double() - want).abs()
                                 <= _spread(lambda gg: term(j, gg), g, d) + 1e-12).all()), key
                    continue
                ws = ref[key + "/s"]
                np.testing.assert_allclose(ent["s"].numpy(), ws.numpy(), rtol=RTOL,
                                           atol=RTOL * float(ws.abs().max()))
                blocks = (*ws.shape, -1)
                units = term(j, g).reshape(blocks) / ws.double()[..., None]
                moved = (_spread(lambda gg: term(j, gg), g, d).reshape(blocks)
                         / ws.double()[..., None]) + RTOL * units.abs()
                q = ent["q"].double().reshape(blocks)
                assert bool(((q - units).abs() <= 0.5 + moved + 1e-9).all()), (i, key)
                codes[0] += int((ent["q"] != ref[key + "/q"]).sum())
                codes[1] += ent["q"].numel()
    # a code off by one needs a value near a rounding boundary: few of them
    print(f"{name}: {codes[0]} of {codes[1]} codes differ from the reference's by one")
    assert codes[0] <= 1e-4 * codes[1], codes


@pytest.mark.parametrize("name", CASES)
def test_8bit_trainer_resumes_to_the_clean_runs_bits(opt8, tmp_path, name):
    """A crash before step 4 and a restore from step 2 end on the clean
    run's params, codes and scales, to the bit; the replayed steps' losses
    are the clean run's."""
    cfg = _cfg(name)
    clean = _trainer(cfg, tmp_path / "clean").run()
    faulty = _trainer(cfg, tmp_path / "faulty",
                      schedule={CRASH: InjectedFault("gpu_memory_errors", node_id=0)}).run()
    assert len(faulty.attempts) == 2 and faulty.final_step == clean.final_step == 4
    (pc, sc), (pf, sf) = _final_state(cfg, tmp_path / "clean"), _final_state(cfg,
                                                                               tmp_path / "faulty")
    assert isinstance(sc.m["embed"], dict) and sc.m["embed"]["q"].dtype == torch.int8
    for k in pc:
        assert torch.equal(pc[k], pf[k]), k
    _assert_equal_states(sc, sf)
    assert clean.losses == faulty.losses[:CRASH] + faulty.losses[CRASH - 1 + 2:]


def _random_8bit_state(seed=0):
    """An 8-bit state of ``_leaves`` after two steps (codes and scales that
    carry values), its params and the next step's gradients."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    p = _leaves(seed)
    s = adamw.init_8bit(p)
    for i in range(2):
        p, s, _ = adamw.apply_8bit(cfg, p, s, _grads(p, i))
    return cfg, p, s


@pytest.mark.parametrize("async_mode", [False, True])
def test_8bit_state_round_trips_the_checkpoint_to_the_bit(tmp_path, async_mode):
    _, p, s = _random_8bit_state()
    mgr = CheckpointManager(tmp_path, async_mode=async_mode)
    mgr.save(2, (p, s), extra={"data_step": 2})
    mgr.wait()
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in p.items()}
    step, (rp, rs), extra = CheckpointManager(tmp_path).restore((meta, adamw.init_8bit(meta)))
    assert step == 2 and extra == {"data_step": 2}
    for k in p:
        assert rp[k].dtype == p[k].dtype and torch.equal(rp[k], p[k]), k
    _assert_equal_states(s, rs)
    manifest = json.loads((tmp_path / "step_000000002" / "manifest.json").read_text())
    assert manifest["dtypes"]["1/.m/w/q"] == "int8" and manifest["dtypes"]["1/.v/w/s"] == "float32"


def test_8bit_checkpoint_in_flight_keeps_its_step_under_a_donated_update(tmp_path, monkeypatch):
    """An async write held back while ``apply_8bit(donate=True)`` overwrites
    the params, codes and scales in place writes the values of its own step."""
    cfg, p, s = _random_8bit_state(seed=1)
    want_p, want_s = _clone(p), _clone(s)
    write_npz = manager_mod._write_npz

    def late_write_npz(*args, **kw):
        time.sleep(0.5)  # the update runs meanwhile
        return write_npz(*args, **kw)

    monkeypatch.setattr(manager_mod, "_write_npz", late_write_npz)
    mgr = CheckpointManager(tmp_path, async_mode=True)
    mgr.save(2, (p, s))
    p2, s2, _ = adamw.apply_8bit(cfg, p, s, _grads(p, 5), donate=True)
    assert not torch.equal(p2["w"], want_p["w"]) and not torch.equal(s2.m["w"]["s"],
                                                                      want_s.m["w"]["s"])
    mgr.wait()
    monkeypatch.undo()
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in p.items()}
    _, (rp, rs), _ = CheckpointManager(tmp_path).restore((meta, adamw.init_8bit(meta)))
    for k in want_p:
        assert torch.equal(rp[k], want_p[k]), k
    _assert_equal_states(want_s, rs)


def test_8bit_training_through_the_launcher_on_cpu(tmp_path):
    """``REPRO_OPT8BIT=1 python -m repro_torch.launch.train --smoke --device
    cpu --steps 2`` trains and exits 0 (it raised a TypeError before the
    trainer made the 8-bit state), and through a crash and a restore."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", REPRO_OPT8BIT="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu"]
    r = subprocess.run(base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a")], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout)["final_step"] == 2
    r = subprocess.run(base + ["--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every",
                               "2", "--inject-rate", "0.3", "--ckpt-dir", str(tmp_path / "b")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout)
    assert rep["final_step"] == 6 and rep["attempts"] >= 2 and np.isfinite(rep["loss_last"])


def test_llama4_cell_trains_one_full_width_layer_under_the_8bit_state():
    """chip_smoke.py's cell: llama4-scout-17b-a16e at full width, one
    chunked layer (4,271,078,400 parameters), under REPRO_OPT8BIT; its
    checkpoint is the 8-bit state's bytes, 25.86 GB (f32 masters, int8
    codes and f32 block scales), not 12 bytes a parameter; two of them and
    the next exceed DISK_BUDGET, so the cell keeps one on disk at a time."""
    arch = "llama4-scout-17b-a16e"
    assert arch in cs.TRAIN_ARCHS and arch in cs.OPT8BIT_ARCHS and not cs.NOT_TRAINED
    cfg, full = cs.train_config(arch), get_arch(arch)
    assert list(cfg.layer_kinds()) == ["chunked"] and cfg.param_count() == 4_271_078_400
    for field in ("d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab_size", "window",
                  "moe"):
        assert getattr(cfg, field) == getattr(full, field), field
    n = cfg.param_count()
    nbytes = cs.state_bytes(cfg, opt8bit=True)
    assert 25.8e9 < nbytes < 25.9e9
    assert nbytes < 12 * n and cs.state_bytes(cfg, opt8bit=False) == 12 * n + 4
    writes = cs.checkpoint_writes(cs.TRAIN["total_steps"], cs.TRAIN["ckpt_every_steps"],
                                  cs.TRAIN_FAULT_STEP)
    assert cs.disk_need(nbytes, writes) > cs.DISK_BUDGET > nbytes


def test_state_bytes_are_the_checkpoints_bytes(opt8, tmp_path):
    """``chip_smoke.state_bytes`` counts every array a trainer's checkpoint
    holds: a smoke 8-bit trainer's checkpoint is that many bytes of arrays."""
    cfg = _cfg("llama4-scout-17b-a16e")
    tr = _trainer(cfg, tmp_path, steps=2)
    tr.run()
    with np.load(tmp_path / "step_000000002" / "arrays.npz") as z:
        held = sum(z[k].nbytes for k in z.files)
    assert held == cs.state_bytes(cfg, opt8bit=True)
