"""Checkpoints and data: repro_torch's CheckpointManager (the cases of
tests/test_checkpoint_data.py on the port), its on-disk interchange with the
JAX package's manager in both directions, the Daly-Young policies, and the
data pipeline (the same token stream as the reference's)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.checkpoint.manager import AdaptiveCheckpointPolicy as JAdaptive
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import get_arch as jget_arch
from repro.configs.base import smoke_config as jsmoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMPipeline as JPipeline
from repro.models import params as jpmod
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.manager import (
    AdaptiveCheckpointPolicy,
    CheckpointManager,
    CheckpointPolicy,
    _flatten,
)
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import FaultTolerantTrainer, TrainerConfig


@pytest.fixture(autouse=True)
def _one_thread():
    """Test workers share the CPU: one intra-op thread each keeps torch's
    thread pools from oversubscribing it (a trainer run is ~50x slower
    otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tmp_ckpt(tmp_path):
    return tmp_path / "ckpt"


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((16, 8), generator=g),
        "b": torch.randn((8,), generator=g).to(torch.bfloat16),
        "nested": {"s": torch.tensor(3, dtype=torch.int32),
                   "m": torch.randn((4, 4), generator=g),
                   "q": torch.randint(-127, 128, (4, 4), generator=g).to(torch.int8)},
    }


def _leaves(tree):
    return list(_flatten(tree).values())


def test_save_restore_bit_exact(tmp_ckpt):
    mgr = CheckpointManager(tmp_ckpt, async_mode=False)
    tree = _tree()
    mgr.save(7, tree, extra={"data_step": 7})
    step, got, extra = mgr.restore(tree)
    assert step == 7 and extra["data_step"] == 7
    assert set(got) == set(tree) and list(got["nested"]) == list(tree["nested"])
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), "bit-exact"


def test_read_npz_gives_np_load_arrays(tmp_path):
    """The restore's reader gives what ``np.load`` gives, member for member:
    dtypes (bf16 bit patterns as uint16), C and Fortran order, a 0-d
    scalar, an empty array."""
    from repro_torch.checkpoint.manager import _read_npz

    rng = np.random.default_rng(3)
    arrays = {"f32": rng.standard_normal((33, 17)).astype(np.float32),
              "fortran": np.asfortranarray(rng.standard_normal((5, 9))),
              "bf16": rng.integers(0, 2 ** 16, (7, 3)).astype(np.uint16),
              "step": np.array(11, np.int32), "int8": rng.integers(-127, 128, 40).astype(np.int8),
              "empty": np.zeros((0, 4), np.float32)}
    np.savez(tmp_path / "a.npz", **arrays)
    got = _read_npz(tmp_path / "a.npz", list(arrays)[::-1])
    with np.load(tmp_path / "a.npz") as want:
        for k in arrays:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].flags.f_contiguous == want[k].flags.f_contiguous, k
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("chunk", [1 << 28, 40])
def test_write_npz_is_the_npz_np_savez_writes(tmp_path, monkeypatch, chunk):
    """The checkpoint writer's npz holds the members ``np.savez`` writes, in
    its order, byte for byte (a Fortran-ordered array in C order, the same
    values), each with its CRC-32: ``zipfile`` checks every member,
    ``np.load`` and the restore's reader give the arrays back.  With a
    40-byte piece, every member is written and read in many pieces."""
    import zipfile

    from repro_torch.checkpoint import manager as manager_mod

    monkeypatch.setattr(manager_mod, "IO_CHUNK", chunk)
    rng = np.random.default_rng(4)
    arrays = {"0/embed": rng.standard_normal((33, 17)).astype(np.float32),
              "1/.m/w": rng.integers(0, 2 ** 16, (7, 3, 5)).astype(np.uint16),
              "1/.step": np.array(11, np.int32), "i64": np.arange(9, dtype=np.int64),
              "empty": np.zeros((0, 4), np.float32),
              "fortran": np.asfortranarray(rng.standard_normal((5, 9)))}
    np.savez(tmp_path / "want.npz", **arrays)
    manager_mod._write_npz(tmp_path / "got.npz", arrays)
    with zipfile.ZipFile(tmp_path / "got.npz") as got, zipfile.ZipFile(tmp_path / "want.npz") as want:
        assert got.testzip() is None
        assert got.namelist() == want.namelist() == [k + ".npy" for k in arrays]
        for name in want.namelist():
            assert (got.read(name) == want.read(name)) == (name != "fortran.npy"), name
    read = manager_mod._read_npz(tmp_path / "got.npz", list(arrays))
    with np.load(tmp_path / "got.npz") as loaded:
        for k, a in arrays.items():
            assert loaded[k].dtype == a.dtype and loaded[k].shape == a.shape, k
            np.testing.assert_array_equal(loaded[k], a)
            np.testing.assert_array_equal(read[k], a)


def test_read_npz_checks_each_members_crc(tmp_path):
    """A flipped byte in a stored member's data fails its CRC-32, as
    ``zipfile`` fails it; a compressed member, which no checkpoint writer
    makes, is refused."""
    import zipfile

    from repro_torch.checkpoint.manager import _read_npz

    np.savez(tmp_path / "a.npz", x=np.arange(1000, dtype=np.float32))
    raw = bytearray((tmp_path / "a.npz").read_bytes())
    at = raw.find(np.arange(1000, dtype=np.float32)[500:504].tobytes())
    raw[at] ^= 1
    (tmp_path / "a.npz").write_bytes(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        _read_npz(tmp_path / "a.npz", ["x"])
    np.savez_compressed(tmp_path / "c.npz", x=np.arange(10))
    with pytest.raises(zipfile.BadZipFile, match="compressed"):
        _read_npz(tmp_path / "c.npz", ["x"])


def test_async_mode_and_gc(tmp_ckpt):
    mgr = CheckpointManager(tmp_ckpt, keep=2, async_mode=True)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]  # GC keeps last 2
    step, _, _ = mgr.restore(tree)
    assert step == 4


def test_atomicity_ignores_partial(tmp_ckpt):
    mgr = CheckpointManager(tmp_ckpt, async_mode=False)
    tree = _tree()
    mgr.save(5, tree)
    # a crashed write: a tmp dir and a final dir missing its manifest
    (tmp_ckpt / ".tmp-step_000000009").mkdir()
    bad = tmp_ckpt / "step_000000008"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 5
    step, _, _ = mgr.restore(tree)
    assert step == 5


def test_restore_shape_mismatch_raises(tmp_ckpt):
    mgr = CheckpointManager(tmp_ckpt, async_mode=False)
    mgr.save(1, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"w": torch.zeros((5, 4))})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_ckpt / "empty").restore({"w": torch.zeros((4, 4))})


def test_restore_into_meta_template(tmp_ckpt):
    """A template of meta tensors (shapes only) is enough to restore."""
    mgr = CheckpointManager(tmp_ckpt, async_mode=False)
    tree = _tree()
    mgr.save(2, tree)
    meta = {"w": torch.empty((16, 8), device="meta"), "b": torch.empty((8,), device="meta"),
            "nested": {k: torch.empty(v.shape, device="meta") for k, v in tree["nested"].items()}}
    _, got, _ = mgr.restore(meta)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(tree), _leaves(got)))


def test_bf16_stored_as_uint16_like_the_reference(tmp_ckpt):
    mgr = CheckpointManager(tmp_ckpt, async_mode=False)
    mgr.save(3, _tree())
    d = tmp_ckpt / "step_000000003"
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["dtypes"] == {"b": "bfloat16", "nested/m": "float32", "nested/q": "int8",
                                  "nested/s": "int32", "w": "float32"}
    with np.load(d / "arrays.npz") as data:
        assert data["b"].dtype == np.uint16 and data["nested/s"].shape == ()


def test_port_checkpoint_restores_in_the_reference_and_back(tmp_path):
    """A tree with bf16, int32 and int8 leaves written by each manager reads
    back identically in the other."""
    tree = _tree(1)
    CheckpointManager(tmp_path / "port", async_mode=False).save(4, tree, extra={"data_step": 4})
    jtemplate = jax.tree_util.tree_map(lambda t: jnp.zeros(t.shape), tree)
    step, jtree, extra = JManager(tmp_path / "port").restore(jtemplate)
    assert step == 4 and extra == {"data_step": 4}
    assert str(jtree["b"].dtype) == "bfloat16" and jtree["nested"]["q"].dtype == np.int8
    for a, b in zip(_leaves(tree), jax.tree_util.tree_leaves(jtree)):
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
    JManager(tmp_path / "jax", async_mode=False).save(6, jtree, extra={"data_step": 6})
    step, back, _ = CheckpointManager(tmp_path / "jax").restore(tree)
    assert step == 6
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _jax_train_state(cfg, seed):
    params = jpmod.materialize(jtransformer.model_defs(cfg), seed=seed)
    opt = jadamw.init(params)
    # non-zero moments and step, so that every leaf carries values
    opt = jadamw.AdamWState(
        jnp.asarray(5, jnp.int32),
        jax.tree_util.tree_map(lambda p: p * 0.5, params),
        jax.tree_util.tree_map(lambda p: p * p, params))
    return params, opt


def test_jax_checkpoint_restores_into_the_port_trainer_and_back(tmp_path):
    """The reference's (params, AdamWState) checkpoint of smoke rsc-llm
    restores into repro_torch's trainer with identical arrays; the trainer
    then trains on and its checkpoint restores into the reference's
    manager with the reference's template."""
    jcfg = jsmoke(jget_arch("rsc-llm"))
    params, opt = _jax_train_state(jcfg, seed=4)
    ckpt = tmp_path / "ckpt"
    JManager(ckpt, async_mode=False).save(5, (params, opt), extra={"data_step": 5})

    tcfg = TrainerConfig(total_steps=7, global_batch=2, seq_len=16, ckpt_dir=str(ckpt),
                         ckpt_every_steps=1, ckpt_async=False, seed=4)
    trainer = FaultTolerantTrainer(smoke_config(get_arch("rsc-llm")), tcfg, device="cpu",
                                   dtype=torch.float32)
    tparams, topt, step = trainer._restore_or_init()
    assert step == 5 and int(topt.step) == 5 and topt.step.dtype == torch.int32
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        a = np.asarray(leaf)
        assert np.array_equal(tparams[key].numpy(), a), key
        assert np.array_equal(topt.m[key].numpy(), a * np.float32(0.5)), key
        assert np.array_equal(topt.v[key].numpy(), a * a), key
    rep = trainer.run()
    assert rep.final_step == 7 and len(rep.losses) == 2

    p0 = jpmod.materialize(jtransformer.model_defs(jcfg), seed=0)
    step, (jp, jo), extra = JManager(ckpt).restore((p0, jadamw.init(p0)))
    assert step == 7 and extra["data_step"] == 7 and int(jo.step) == 7
    _, (tp, to), _ = CheckpointManager(ckpt).restore(
        ({k: torch.empty(v.shape) for k, v in tparams.items()}, adamw.init(tparams)))
    for key, leaf in tp.items():
        want = jp
        for part in key.split("/"):
            want = want[int(part)] if isinstance(want, list) else want[part]
        assert np.array_equal(leaf.numpy(), np.asarray(want)), key


def test_policy_daly_young_interval():
    p = CheckpointPolicy(n_nodes=1536, r_f_per_node_day=6.5e-3, w_cp_s=300.0)
    # sqrt(2*300 / (1536*6.5e-3/86400)) ~ 2276 s
    assert p.interval_s() == pytest.approx(2276, rel=0.02)
    p2 = CheckpointPolicy(n_nodes=1536, r_f_per_node_day=6.5e-3, w_cp_s=10.0)
    assert p2.interval_s() < p.interval_s()
    assert p.should_save(0.0, 2300.0) and not p.should_save(0.0, 2000.0)


def test_adaptive_policy_matches_the_reference():
    a, b = AdaptiveCheckpointPolicy(n_nodes=64), JAdaptive(n_nodes=64)
    assert a.interval_s() == b.interval_s() == CheckpointPolicy(n_nodes=64).interval_s()
    for pol in (a, b):
        pol.observe(n_failures=40, node_days=500)
    assert a.r_f_effective == b.r_f_effective > 6.5e-3
    assert a.interval_s() == b.interval_s()


# -- data pipeline ---------------------------------------------------------
def test_pipeline_deterministic_across_instances():
    cfg = DataConfig(vocab_size=512, seq_len=64, global_batch=4, seed=9)
    a, b = SyntheticLMPipeline(cfg), SyntheticLMPipeline(cfg)
    for _ in range(3):
        assert np.array_equal(a.next_batch()["tokens"], b.next_batch()["tokens"])


def test_pipeline_restore_resumes_stream():
    cfg = DataConfig(vocab_size=512, seq_len=64, global_batch=4, seed=9)
    p = SyntheticLMPipeline(cfg)
    batches = [p.next_batch()["tokens"] for _ in range(5)]
    p2 = SyntheticLMPipeline(cfg)
    p2.restore(3)
    assert np.array_equal(p2.next_batch()["tokens"], batches[3])
    assert np.array_equal(p2.next_batch()["tokens"], batches[4])
    assert p2.state.to_dict() == {"step": 5, "seed": 9}


@given(st.integers(0, 1000))
def test_pipeline_batch_is_pure_function_of_step(step):
    cfg = DataConfig(vocab_size=128, seq_len=32, global_batch=2, seed=1)
    p = SyntheticLMPipeline(cfg)
    a, b = p.batch_at(step)["tokens"], p.batch_at(step)["tokens"]
    assert np.array_equal(a, b)
    assert a.shape == (2, 33) and a.min() >= 1 and a.max() < 128


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (2, 41)])
def test_pipeline_gives_the_reference_stream(seed, step):
    kw = dict(vocab_size=32000, seq_len=128, global_batch=3, seed=seed)
    a = SyntheticLMPipeline(DataConfig(**kw)).batch_at(step)["tokens"]
    b = JPipeline(JDataConfig(**kw)).batch_at(step)["tokens"]
    assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
