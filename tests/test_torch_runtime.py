"""repro_torch's fault-tolerant trainer on the CPU: the scenarios of
tests/test_runtime.py (requeue, bit-exact resume, ETTR accounting, lemon
exclusion) on smoke rsc-llm, the monitors, the copied reliability models
held to the reference's, and the training launcher."""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.core import ettr_model as jettr
from repro.core import lemon as jlemon
from repro.core import taxonomy as jtaxonomy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.core import ettr_model, lemon, taxonomy
from repro_torch.models import params as pmod
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.runtime.fault_injection import FaultInjector, InjectedFault
from repro_torch.runtime.monitor import CollectiveTracer, StragglerMonitor
from repro_torch.runtime.train_loop import FaultTolerantTrainer, TrainerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


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
def cfg():
    return smoke_config(get_arch("rsc-llm"))


def _train(cfg, tmp, schedule=None, steps=24, ckpt_every=4, seed=0, dtype=torch.float32,
           injector=None, ckpt_async=False):
    inj = injector or FaultInjector(schedule=schedule or {})
    tcfg = TrainerConfig(total_steps=steps, global_batch=4, seq_len=32,
                         ckpt_dir=str(tmp), ckpt_every_steps=ckpt_every,
                         ckpt_async=ckpt_async, n_nodes=4, seed=seed)
    tr = FaultTolerantTrainer(cfg, tcfg, inj, device="cpu", dtype=dtype)
    return tr, tr.run()


def test_completes_despite_faults(cfg, tmp_path):
    sched = {6: InjectedFault("pcie_errors", node_id=1),
             14: InjectedFault("ib_link_error", node_id=2)}
    tr, rep = _train(cfg, tmp_path / "a", schedule=sched)
    assert rep.final_step == 24
    assert len(rep.attempts) == 3
    outcomes = [a.outcome for a in rep.attempts]
    assert outcomes[0] == "fault:pcie_errors"
    assert outcomes[-1] == "completed"
    assert [(a.start_step, a.end_step) for a in rep.attempts] == [(0, 6), (4, 14), (12, 24)]
    assert {1, 2} <= rep.excluded_nodes  # high-severity drains
    assert 0.0 < rep.measured_ettr <= 1.0
    # 6 + 10 + 12 executed steps: each crash loses the steps since the last save
    assert len(rep.losses) == len(rep.step_wall_s) == 28
    assert rep.lost_step_wall_s > 0 and rep.restart_overhead_s > 0


def _final_checkpoint(cfg, ckpt_dir, seed):
    p0 = pmod.materialize(transformer.model_defs(cfg), seed=seed)
    _, (params, opt), _ = CheckpointManager(ckpt_dir).restore((p0, adamw.init(p0)))
    return params, opt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_faulty_run_matches_clean_run_bit_exact(cfg, tmp_path, dtype):
    """Crash + restore replays the same data and lands on identical params
    and optimizer state (determinism is what makes ETTR the only cost of a
    failure); in f32 and in bf16 compute."""
    _, clean = _train(cfg, tmp_path / "clean", steps=16, ckpt_every=4, seed=7, dtype=dtype)
    _, faulty = _train(cfg, tmp_path / "faulty", steps=16, ckpt_every=4, seed=7, dtype=dtype,
                       schedule={10: InjectedFault("gpu_memory_errors", node_id=0)})
    assert faulty.final_step == clean.final_step == 16 and len(faulty.attempts) == 2
    pc, oc = _final_checkpoint(cfg, tmp_path / "clean", 7)
    pf, of = _final_checkpoint(cfg, tmp_path / "faulty", 7)
    for k in pc:
        assert torch.equal(pc[k], pf[k]), k
        assert torch.equal(oc.m[k], of.m[k]) and torch.equal(oc.v[k], of.v[k]), k
    assert int(oc.step) == int(of.step) == 16
    assert clean.losses == faulty.losses[:10] + faulty.losses[10 + 2:]  # replayed 8, 9


def test_async_checkpoint_of_a_donated_step_resumes_bit_exact(cfg, tmp_path, monkeypatch):
    """An async write that is still running while the next steps update the
    params and moments in place writes the values of its own step: with the
    npz writer (``manager._write_npz``) held back, the run that crashes and
    resumes from such a checkpoint lands on the clean run's bits."""
    from repro_torch.checkpoint import manager as manager_mod

    _, clean = _train(cfg, tmp_path / "clean", steps=12, ckpt_every=4, seed=5)
    write_npz = manager_mod._write_npz

    def late_write_npz(*args, **kw):
        time.sleep(0.5)  # the step loop runs on meanwhile
        return write_npz(*args, **kw)

    monkeypatch.setattr(manager_mod, "_write_npz", late_write_npz)
    tr, faulty = _train(cfg, tmp_path / "faulty", steps=12, ckpt_every=4, seed=5,
                        ckpt_async=True,
                        schedule={7: InjectedFault("gpu_memory_errors", node_id=0)})
    monkeypatch.undo()
    assert faulty.final_step == 12 and [a.start_step for a in faulty.attempts] == [0, 4]
    pc, oc = _final_checkpoint(cfg, tmp_path / "clean", 5)
    pf, of = _final_checkpoint(cfg, tmp_path / "faulty", 5)
    for k in pc:
        assert torch.equal(pc[k], pf[k]), k
        assert torch.equal(oc.m[k], of.m[k]) and torch.equal(oc.v[k], of.v[k]), k
    assert clean.losses == faulty.losses[:7] + faulty.losses[7 + 3:]  # replayed 4, 5, 6


def test_loss_decreases(cfg, tmp_path):
    _, rep = _train(cfg, tmp_path / "l", steps=30)
    assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:5])


def test_poisson_injection_ettr_reasonable(cfg, tmp_path):
    inj = FaultInjector(rate_per_step=0.15, n_nodes=4, seed=2)
    _, rep = _train(cfg, tmp_path / "p", steps=30, ckpt_every=3, seed=2, injector=inj)
    assert rep.final_step == 30
    assert len(rep.attempts) >= 2
    assert 0.2 <= rep.measured_ettr <= 1.0


def test_lemon_node_excluded_after_repeat_offenses(cfg, tmp_path):
    sched = {5: InjectedFault("ethlink_errors", node_id=3),
             9: InjectedFault("ethlink_errors", node_id=3),
             13: InjectedFault("ethlink_errors", node_id=3)}
    tr, rep = _train(cfg, tmp_path / "lemon", schedule=sched, steps=20)
    assert 3 in rep.excluded_nodes
    assert any(v.node_id == 3 for v in rep.lemon_verdicts)


def test_async_checkpoints_and_straggler_fault(cfg, tmp_path):
    """Async writes (the step loop pays only the copy to the host), an
    injected straggler that is observed, and ETTR's parts adding up."""
    sched = {3: InjectedFault("nccl_timeout", node_id=2, kind="straggler", slowdown=4.0)}
    tr, rep = _train(cfg, tmp_path / "s", schedule=sched, steps=8, ckpt_every=2,
                     ckpt_async=True)
    assert rep.final_step == 8 and len(rep.attempts) == 1
    assert tr.manager.all_steps() == [6, 8]
    assert tr.stragglers.history[2][3] == pytest.approx(4.0 * tr.stragglers.history[0][3])
    assert rep.productive_wall_s == pytest.approx(
        rep.total_wall_s - rep.checkpoint_block_s - rep.restart_overhead_s
        - rep.lost_step_wall_s)


def test_restart_waits_for_the_checkpoint_still_being_written(cfg, tmp_path, monkeypatch):
    """A crash right after an async save whose write is still running (a
    full-width checkpoint takes seconds to write) restores that checkpoint,
    the one the ETTR accounting counted lost work from."""
    write = CheckpointManager._write

    def slow_write(self, *args):
        time.sleep(0.5)
        write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", slow_write)
    _, rep = _train(cfg, tmp_path / "w", steps=4, ckpt_every=2, ckpt_async=True,
                    schedule={3: InjectedFault("gpu_memory_errors", node_id=0)})
    assert [(a.start_step, a.end_step) for a in rep.attempts] == [(0, 3), (2, 4)]
    assert rep.restart_overhead_s > 0.3  # the restart waited for the write


# -- monitors ----------------------------------------------------------------
def test_straggler_monitor_flags_slow_node():
    mon = StragglerMonitor(n_nodes=4, threshold=1.5, patience=2)
    newly = set()
    for step in range(4):
        newly |= mon.observe(step, {0: 1.0, 1: 1.0, 2: 1.0, 3: 3.0})
    assert mon.flagged == {3} and newly == {3}


def test_straggler_monitor_ignores_uniform_slowdown():
    mon = StragglerMonitor(n_nodes=4)
    for step in range(5):
        mon.observe(step, {i: 2.0 for i in range(4)})
    assert not mon.flagged


def test_straggler_monitor_strike_reset_on_healthy_step():
    mon = StragglerMonitor(n_nodes=3, threshold=1.5, patience=3)
    slow = {0: 1.0, 1: 1.0, 2: 4.0}
    healthy = {0: 1.0, 1: 1.0, 2: 1.0}
    assert mon.observe(0, slow) == set()
    assert mon.observe(1, slow) == set()
    assert mon.observe(2, healthy) == set()    # resets node 2
    assert mon.observe(3, slow) == set()
    assert mon.observe(4, slow) == set()
    assert not mon.flagged
    assert mon.observe(5, slow) == {2}


def test_straggler_monitor_flags_once():
    mon = StragglerMonitor(n_nodes=2, threshold=1.5, patience=1)
    slow = {0: 1.0, 1: 5.0}
    assert mon.observe(0, slow) == {1}
    for step in range(1, 4):
        assert mon.observe(step, slow) == set()
    assert mon.flagged == {1}


def test_collective_tracer_finds_missing_and_stuck_ranks():
    tr = CollectiveTracer(n_ranks=4)
    for cid in ("ar_0", "ar_1"):
        for r in range(4):
            tr.enter(cid, r)
            tr.exit(cid, r)
    for r in (0, 1, 3):  # rank 2 never arrives at ar_2
        tr.enter("ar_2", r)
    assert tr.diagnose() == {"collective": "ar_2", "kind": "missing_entry",
                             "culprit_ranks": [2]}
    tr2 = CollectiveTracer(n_ranks=2)
    tr2.enter("ar_0", 0)
    tr2.enter("ar_0", 1)
    tr2.exit("ar_0", 0)  # rank 1 stuck inside
    assert tr2.diagnose()["kind"] == "stuck_inside" and tr2.diagnose()["culprit_ranks"] == [1]
    tr2.enter("ar_1", 0)  # ...and never reaches ar_1: missing entry wins
    assert tr2.diagnose() == {"collective": "ar_1", "kind": "missing_entry",
                              "culprit_ranks": [1]}
    healthy = CollectiveTracer(n_ranks=2)
    for r in range(2):
        healthy.enter("ar_0", r)
        healthy.exit("ar_0", r)
    assert healthy.diagnose() is None


def test_monitors_as_metric_sources():
    mon = StragglerMonitor(n_nodes=2, threshold=1.5, patience=1)
    mon.observe(0, {0: 1.0, 1: 5.0})
    tr = CollectiveTracer(n_ranks=2)
    tr.enter("ar_0", 0)
    assert mon.as_metric_source()() == {"n_flagged": 1, "flagged": [1], "n_striking": 1,
                                        "n_steps": 1}
    assert tr.as_metric_source()() == {"n_collectives": 1, "diagnosis_kind": "missing_entry",
                                       "culprit_ranks": [1]}


# -- the copied reliability models, held to the reference --------------------
@pytest.mark.parametrize("kw", [
    dict(n_nodes=1536), dict(n_nodes=4, w_cp_s=0.0), dict(n_nodes=64, q_s=600.0, u0_s=30.0),
    dict(n_nodes=8, dt_cp_s=1200.0, r_f=0.05), dict(n_nodes=20000, r_f=0.02)])
def test_ettr_model_matches_the_reference(kw):
    a, b = ettr_model.ETTRParams(**kw), jettr.ETTRParams(**kw)
    assert ettr_model.expected_ettr(a) == jettr.expected_ettr(b)
    assert ettr_model.expected_n_failures(a) == jettr.expected_n_failures(b)
    assert a.resolved_dt_s() == b.resolved_dt_s()


def test_taxonomy_diagnosis_matches_the_reference():
    assert taxonomy.HW_SYMPTOMS == jtaxonomy.HW_SYMPTOMS
    cases = [[], ["oom"], ["nccl_timeout", "pcie_errors"], ["ethlink_errors", "oom"],
             ["gpu_driver_firmware", "system_services"], ["unknown", "ib_link_error"]]
    for symptoms in cases:
        assert taxonomy.diagnose(symptoms).value == jtaxonomy.diagnose(symptoms).value
        assert taxonomy.most_likely_cause(symptoms) == jtaxonomy.most_likely_cause(symptoms)


def test_lemon_detector_matches_the_reference():
    rng = np.random.default_rng(5)
    for node in range(50):
        counts = dict(excl_jobid_count=int(rng.integers(0, 12)), xid_cnt=int(rng.integers(0, 6)),
                      tickets=int(rng.integers(0, 3)), out_count=int(rng.integers(0, 5)),
                      multi_node_node_fails=int(rng.integers(0, 5)),
                      single_node_node_fails=int(rng.integers(0, 3)),
                      single_node_jobs=int(rng.integers(0, 5)))
        a = lemon.LemonDetector().evaluate(lemon.NodeHistory(node, **counts))
        b = jlemon.LemonDetector().evaluate(jlemon.NodeHistory(node, **counts))
        assert (a.is_lemon, a.tripped, a.score) == (b.is_lemon, b.tripped, b.score)


# -- the launcher ------------------------------------------------------------
def test_train_launcher_defaults_to_cuda_and_runs_on_cpu_when_asked(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--steps", "8",
           "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck")]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    r = subprocess.run(cmd + ["--device", "cpu", "--ckpt-every", "2", "--inject-rate", "0.2"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rep = json.loads(r.stdout)
    assert rep["arch"] == "rsc-llm-smoke" and rep["final_step"] == 8 and rep["attempts"] >= 1
    assert 0.0 < rep["measured_ettr"] <= 1.0 and np.isfinite(rep["loss_last"])

