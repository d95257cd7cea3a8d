"""Fault-tolerant training loop — the paper's job lifecycle, live (after
``repro.runtime.train_loop``).

One ``FaultTolerantTrainer.run()`` is a *job run* in the paper's sense: a
sequence of attempts (scheduler jobs) separated by injected infra failures.
Each attempt restores the newest complete checkpoint (params + optimizer +
data-pipeline state, bit-exact), trains until fault or completion, and
checkpoints every ``ckpt_every_steps`` steps or at the Daly-Young interval.
The trainer accounts productive vs unproductive wall time exactly as §II-D
defines ETTR: productive = total - checkpoint block - restart - lost work.

Health-check semantics: on a crash fault, the "node" is marked unhealthy
and a high-severity one is excluded from the next attempt's placement;
lemon nodes accumulate NodeHistory and get excluded by the LemonDetector
after repeated offenses.

On CUDA the run is deterministic, so a restored run lands on the same bits
as a clean one: the trainer turns on ``torch.use_deterministic_algorithms``
(the embedding's backward, an ``index_put`` with accumulate, is
non-deterministic by default) and requires ``CUBLAS_WORKSPACE_CONFIG`` set
to ``:4096:8`` (or ``:16:8``) before CUDA initialises, for cuBLAS.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager, CheckpointPolicy
from repro_torch.configs.base import ArchConfig
from repro_torch.core.lemon import LemonDetector, NodeHistory
from repro_torch.core.taxonomy import TAXONOMY
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.models import params as pmod
from repro_torch.models import transformer
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw
from repro_torch.runtime.fault_injection import FaultInjector, SimulatedFault
from repro_torch.runtime.monitor import StragglerMonitor
from repro_torch.runtime.serve_loop import resolve_device

CUBLAS_DETERMINISTIC = (":4096:8", ":16:8")


def require_deterministic() -> None:
    """Make CUDA training reproducible to the bit, or raise."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in CUBLAS_DETERMINISTIC:
        raise RuntimeError(
            "training on CUDA is deterministic: set CUBLAS_WORKSPACE_CONFIG=:4096:8 in the "
            "environment before CUDA initialises")
    torch.use_deterministic_algorithms(True)


@dataclass
class TrainerConfig:
    total_steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_async: bool = True
    ckpt_every_steps: int = 0      # 0 -> wall-time Daly-Young policy
    n_nodes: int = 4               # simulated node count (for accounting)
    r_f_per_node_day: float = 6.50e-3
    sim_u0_s: float = 0.0          # simulated restart overhead (sleep)
    max_attempts: int = 64
    seed: int = 0
    lr: float = 1e-3
    grad_compression: Optional[str] = None
    n_microbatches: int = 1


@dataclass
class AttemptRecord:
    attempt: int
    start_step: int
    end_step: int
    wall_s: float
    outcome: str              # completed | fault:<symptom>
    excluded_nodes: tuple = ()


@dataclass
class TrainReport:
    attempts: list
    losses: list
    total_wall_s: float
    productive_wall_s: float
    checkpoint_block_s: float
    restart_overhead_s: float
    lost_step_wall_s: float
    final_step: int
    excluded_nodes: set
    lemon_verdicts: list
    step_wall_s: list = field(default_factory=list)  # every executed step, in order

    @property
    def measured_ettr(self) -> float:
        if self.total_wall_s <= 0:
            return 0.0
        return self.productive_wall_s / self.total_wall_s


# checkpoints kept on disk, as the reference's trainer keeps them
KEEP = 2


def optimizer_config(tcfg: TrainerConfig) -> adamw.AdamWConfig:
    """The trainer's AdamW schedule: warmup over 5 steps to ``tcfg.lr``."""
    return adamw.AdamWConfig(lr=tcfg.lr, warmup_steps=5, total_steps=max(tcfg.total_steps, 10))


def _to(tree, device):
    """A tensor, or each tensor of nested dicts (the 8-bit moments' {"q",
    "s"} entries), on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(t, device) for k, t in tree.items()}
    return tree.to(device)


class FaultTolerantTrainer:
    """Runs on the card unless ``device`` says otherwise; ``dtype`` is the
    compute dtype (masters stay f32, and the optimizer state f32 or, under
    ``REPRO_OPT8BIT=1``, int8 with f32 block scales)."""

    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig,
                 injector: Optional[FaultInjector] = None, *,
                 device: Optional[torch.device | str] = None,
                 dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.tcfg = tcfg
        self.injector = injector or FaultInjector()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            require_deterministic()
        self.defs = transformer.model_defs(cfg)
        self.step_fn = make_train_step(
            cfg, optimizer_config(tcfg), grad_compression=tcfg.grad_compression,
            n_microbatches=tcfg.n_microbatches, dtype=dtype,
            # the loop drops the params and state it passes: updated in
            # place, they are held once (the same bits)
            donate=True)
        # the optimizer state the step takes: f32 moments, or int8 codes and
        # f32 block scales under REPRO_OPT8BIT=1 (the reference's trainer
        # makes f32 moments for either step, so its 8-bit step fails)
        self.init_opt = adamw.init_8bit if self.step_fn.opt8bit else adamw.init
        self.pipeline = SyntheticLMPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed))
        self.policy = CheckpointPolicy(
            n_nodes=tcfg.n_nodes, r_f_per_node_day=tcfg.r_f_per_node_day)
        self.manager = CheckpointManager(tcfg.ckpt_dir, keep=KEEP,
                                         async_mode=tcfg.ckpt_async)
        self.node_histories = {i: NodeHistory(i) for i in range(tcfg.n_nodes)}
        self.detector = LemonDetector()
        self.excluded: set[int] = set()
        self.stragglers = StragglerMonitor(tcfg.n_nodes)

    # ------------------------------------------------------------------
    def _init_state(self):
        params = pmod.materialize(self.defs, seed=self.tcfg.seed, device=self.device)
        return params, self.init_opt(params)

    def _restore_or_init(self):
        # an async write still in flight is a checkpoint the accounting has
        # already taken (lost work counts from it): wait for it before
        # choosing the step to restore (the reference looks first, and at
        # full width restarts from an older checkpoint)
        self.manager.wait()
        if self.manager.latest_step() is None:
            self.pipeline.restore(0)
            params, opt_state = self._init_state()
            return params, opt_state, 0
        # the structure to restore into: shapes only, nothing materialized
        p0 = {path: torch.empty(d.shape, dtype=d.dtype, device="meta")
              for path, d in pmod.flatten(self.defs)}
        step, (params, opt_state), extra = self.manager.restore((p0, self.init_opt(p0)))
        params = _to(params, self.device)
        opt_state = adamw.AdamWState(*(_to(x, self.device) for x in opt_state))
        start_step = int(extra.get("data_step", step))
        self.pipeline.restore(start_step)
        return params, opt_state, start_step

    def _handle_fault(self, fault, step: int) -> None:
        """Health-check response: attribute, record lemon signals, exclude."""
        h = self.node_histories.setdefault(fault.node_id, NodeHistory(fault.node_id))
        if fault.symptom.startswith("gpu"):
            h.xid_cnt += 1
        h.multi_node_node_fails += 1
        h.out_count += 1
        if TAXONOMY[fault.symptom].severity == "high":
            self.excluded.add(fault.node_id)  # drain immediately
        if self.detector.evaluate(h).is_lemon:
            self.excluded.add(fault.node_id)

    def _batch(self) -> dict:
        return {k: torch.from_numpy(v).to(self.device, torch.long)
                for k, v in self.pipeline.next_batch().items()}

    # ------------------------------------------------------------------
    def run(self) -> TrainReport:
        tc = self.tcfg
        attempts: list[AttemptRecord] = []
        losses: list[float] = []
        run_t0 = time.time()
        ckpt_block_s = 0.0
        restart_s = 0.0
        lost_s = 0.0
        step = 0
        attempt_no = 0
        step_walls: list[float] = []

        while step < tc.total_steps and attempt_no < tc.max_attempts:
            attempt_no += 1
            a_t0 = time.time()
            if tc.sim_u0_s:
                time.sleep(tc.sim_u0_s)
            params, opt_state, step = self._restore_or_init()
            restart_s += time.time() - a_t0
            last_ckpt_t = time.time()
            since_ckpt_wall = 0.0
            outcome = "completed"
            start_step = step
            try:
                while step < tc.total_steps:
                    fault = self.injector.poll(step)
                    if fault is not None and fault.kind == "crash":
                        raise SimulatedFault(fault)
                    s_t0 = time.time()
                    batch = self._batch()
                    if fault is not None and fault.kind == "straggler":
                        time.sleep(fault.slowdown * 0.01)
                    params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                    losses.append(float(metrics["loss"]))  # waits for the step
                    step += 1
                    wall = time.time() - s_t0
                    step_walls.append(wall)
                    since_ckpt_wall += wall
                    # straggler observation (uniform nodes + injected slow one)
                    times = {i: wall for i in range(tc.n_nodes)}
                    if fault is not None and fault.kind == "straggler":
                        times[fault.node_id] = wall * fault.slowdown
                    self.stragglers.observe(step, times)
                    save_now = (
                        (tc.ckpt_every_steps and step % tc.ckpt_every_steps == 0)
                        or (not tc.ckpt_every_steps
                            and self.policy.should_save(last_ckpt_t, time.time()))
                        or step == tc.total_steps)
                    if save_now:
                        ckpt_block_s += self.manager.save(
                            step, (params, opt_state), extra={"data_step": step})
                        last_ckpt_t = time.time()
                        since_ckpt_wall = 0.0
            except SimulatedFault as e:
                outcome = f"fault:{e.fault.symptom}"
                self._handle_fault(e.fault, step)
                lost_s += since_ckpt_wall  # work since last checkpoint
            attempts.append(AttemptRecord(
                attempt_no, start_step, step, time.time() - a_t0, outcome,
                tuple(sorted(self.excluded))))

        self.manager.wait()
        lemon_verdicts = self.detector.scan(self.node_histories.values())
        total_wall = time.time() - run_t0
        productive = max(total_wall - ckpt_block_s - restart_s - lost_s, 0.0)
        return TrainReport(
            attempts=attempts, losses=losses, total_wall_s=total_wall,
            productive_wall_s=productive, checkpoint_block_s=ckpt_block_s,
            restart_overhead_s=restart_s, lost_step_wall_s=lost_s,
            final_step=step, excluded_nodes=set(self.excluded),
            lemon_verdicts=[v for v in lemon_verdicts if v.is_lemon],
            step_wall_s=step_walls)
