"""Worker-pool ensemble executor + per-cell replay scoring.

One *cell* is one full ``ClusterSim`` replay at a (scale, seed) grid
point.  Cells are embarrassingly parallel, so ``run_cells`` fans any
picklable task list out over a ``multiprocessing`` spawn pool and streams
results back in completion order; each replay cell records a trace,
scores it in-worker with ``score_cell``, and returns only the compact
``CellStats`` scalars — a paper-scale ensemble never holds more than one
trace per worker in RAM.

``run_cells`` is the repo's single worker-pool implementation: the
mitigation sweep (``repro_torch.mitigations.sweep``) and the ensemble CLI both
execute through it.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import asdict, dataclass, field, fields, replace
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.cluster import analysis
from repro_torch.cluster.workload import ClusterSpec
from repro_torch.core.ettr_model import ETTRParams, expected_ettr
from repro_torch.core.metrics import job_run_ettr, mttf

# RSC-1 scaling: 7.2k jobs/day on 2000 nodes, 83% target utilization
JOBS_PER_NODE_DAY = 3.6
W_CP_S = 300.0            # sync checkpoint write cost (paper Fig. 10 axis)
U0_S = 300.0              # restart/init overhead
# paper's typical cadence for larger jobs — the baseline accounting interval
DEFAULT_CP_INTERVAL_S = 3600.0


def scaled_spec(n_gpus: int, *, gpus_per_node: int = 8,
                r_f: float = 6.5e-3) -> ClusterSpec:
    """An RSC-1-like cluster shrunk (or grown) to ``n_gpus``: job mix
    capped at the cluster size, per-node arrival rate and utilization
    target preserved."""
    n_nodes = max(1, n_gpus // gpus_per_node)
    return ClusterSpec(
        "RSC-1", n_nodes=n_nodes, gpus_per_node=gpus_per_node,
        jobs_per_day=n_nodes * JOBS_PER_NODE_DAY,
        target_utilization=0.83, r_f=r_f,
        max_job_gpus=n_nodes * gpus_per_node)


def default_min_gpus(n_gpus: int) -> int:
    """Qualifying-job floor for the ETTR/MTTF metrics: large-ish relative
    to the cluster (>= 1/16th of capacity, floor 64 GPUs) — small enough
    that every scale yields a usable sample inside a days-long horizon."""
    return max(64, n_gpus // 16)


# ---------------------------------------------------------------------------
# per-cell scoring (shared by the ensemble runner and the mitigation sweep)
# ---------------------------------------------------------------------------
def _measured_and_modeled(sim, trace, policy, *, min_gpus: int,
                          min_hours: float, r_f_nominal: float):
    """Per qualifying run (grouped from the cell's trace): measured ETTR
    (the policy's checkpoint cadence, hourly if no policy) and the two
    analytic predictions (realized interruption rates / nominal r_f).

    Hot-path v3: qualifying rows are selected as one column mask and
    only *those* rows materialize as ``JobRecord`` objects (requeued
    attempts share their run's n_gpus, so a row-level size filter equals
    the run-level one); the full jobs table never leaves its arrays.
    The per-run ETTR math is unchanged — same floats as the v2 path."""
    jobs_cols = trace.tables["jobs"]
    qual_idx = np.nonzero(jobs_cols["n_gpus"] >= min_gpus)[0]
    runs: dict[int, list] = {}
    for rec in trace.job_records_at(qual_idx):
        runs.setdefault(rec.run_id, []).append(rec)
    measured, modeled, modeled_nom = [], [], []
    for jobs in runs.values():
        g = jobs[0].n_gpus
        scheduled_s = sum(j.run_time for j in jobs)
        if scheduled_s < min_hours * 3600.0:
            continue
        job_nodes = max(1, math.ceil(g / sim.spec.gpus_per_node))
        # realized interruption rate (incl. preemptions and user failures
        # the hardware-only analytic model does not see) — computed before
        # the cadence so rate-tuned cadence controllers can use it
        n_int = sum(1 for j in jobs if j.state.value != "COMPLETED")
        run_days = max(scheduled_s, 3600.0) / 86400.0
        rf_eff = max(n_int / run_days / job_nodes, r_f_nominal)
        interval = policy.checkpoint_interval_s(sim, g, realized_rf=rf_eff) \
            if policy is not None else None
        if interval is None:
            interval = DEFAULT_CP_INTERVAL_S
        m = job_run_ettr(jobs, checkpoint_interval=interval, w_cp=W_CP_S,
                         u0=U0_S)
        measured.append(m.ettr)
        n_att = max(m.n_interruptions + 1, 1)
        common = dict(n_nodes=job_nodes, w_cp_s=W_CP_S, u0_s=U0_S,
                      dt_cp_s=interval, q_s=m.queue / n_att,
                      runtime_s=max(m.productive, 3600.0))
        # the NUMPY tier whatever REPRO_TORCH_STAT_BACKEND says: scoring is
        # the float64 oracle, and a worker never touches the card
        modeled.append(expected_ettr(ETTRParams(r_f=rf_eff, **common),
                                     backend="numpy"))
        modeled_nom.append(expected_ettr(ETTRParams(r_f=r_f_nominal,
                                                    **common),
                                         backend="numpy"))
    return measured, modeled, modeled_nom


def score_cell(sim, trace, *, policy=None, min_gpus: Optional[int] = None,
               min_hours: float = 12.0,
               r_f_nominal: Optional[float] = None) -> dict:
    """Score one replay's recorded trace into the shared per-cell metric
    dict: measured/modeled ETTR over qualifying runs, MTTF over large
    jobs, goodput, fitted failure rate, and the fault attribution mix.
    Pure function of (trace, policy cadence) — bit-deterministic, which
    is what makes ensemble bands reproducible across worker counts."""
    spec = sim.spec
    if r_f_nominal is None:
        r_f_nominal = spec.r_f
    if min_gpus is None:
        min_gpus = default_min_gpus(spec.n_nodes * spec.gpus_per_node)
    measured, modeled, modeled_nom = _measured_and_modeled(
        sim, trace, policy, min_gpus=min_gpus, min_hours=min_hours,
        r_f_nominal=r_f_nominal)

    # whole-table aggregates as column array ops (hot-path v3): the
    # worker scores a cell without materializing a JobRecord per row
    jobs_cols = trace.tables["jobs"]
    n_gpus_col = jobs_cols["n_gpus"]
    run_time_col = analysis.jobs_run_time(jobs_cols)
    large_mask = n_gpus_col >= min_gpus
    n_records = len(n_gpus_col)
    n_infra = int((analysis.infra_failure_mask(jobs_cols)
                   & large_mask).sum())
    large_runtime_s = float(run_time_col[large_mask].sum())
    loss = analysis.goodput_loss_columns(jobs_cols)
    scheduled_gpu_s = float((run_time_col * n_gpus_col).sum())
    capacity_gpu_s = spec.n_nodes * spec.gpus_per_node * sim.horizon_s
    goodput = (scheduled_gpu_s - loss.failure_loss_gpu_s
               - loss.preemption_loss_gpu_s) / max(capacity_gpu_s, 1e-9)

    # Fig. 4-style attribution mix: fraction of logged faults per symptom
    # (sorted by symptom for deterministic ordering)
    symptoms = trace.tables["faults"]["symptom"]
    attribution: dict[str, float] = {}
    if len(symptoms):
        uniq, counts = np.unique(symptoms, return_counts=True)
        total = float(counts.sum())
        attribution = {str(s): float(c) / total
                       for s, c in zip(uniq.tolist(), counts.tolist())}

    n_evicted = int(np.sum(trace.tables["node_events"]["event"] == "evict"))
    return {
        "n_records": n_records,
        "n_faults": trace.n_rows("faults"),
        "n_infra_failures": n_infra,
        "n_runs_measured": len(measured),
        "ettr_sim": float(np.mean(measured)) if measured else float("nan"),
        "ettr_model": float(np.mean(modeled)) if modeled else float("nan"),
        "ettr_model_nominal": (float(np.mean(modeled_nom)) if modeled_nom
                               else float("nan")),
        "mttf_large_h": mttf(large_runtime_s / 3600.0, n_infra),
        "goodput": goodput,
        "fitted_r_f": analysis.fit_r_f_columns(jobs_cols,
                                               min_gpus=min_gpus // 2),
        "attribution": attribution,
        "n_evicted": n_evicted,
    }


# ---------------------------------------------------------------------------
# replay cells
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ReplayCell:
    """One (scale, seed) grid point of a bare-engine replay ensemble."""

    n_gpus: int
    seed: int
    horizon_days: float = 8.0
    r_f: float = 6.5e-3
    min_hours: float = 12.0
    min_gpus: Optional[int] = None   # None -> default_min_gpus(n_gpus)
    scenario: Optional[str] = None   # fault-model v2 pack name
    episode: Optional[str] = None    # what-if episode token (episodes.py)


@dataclass
class CellStats:
    """Compact per-cell result streamed back from a worker (scalars plus
    the small attribution dict — never the trace itself)."""

    n_gpus: int
    seed: int
    wall_s: float
    sim_days: float
    n_records: int
    n_faults: int
    n_infra_failures: int
    n_runs_measured: int
    ettr_sim: float
    ettr_model: float
    ettr_model_nominal: float
    mttf_large_h: float
    goodput: float
    fitted_r_f: float
    n_evicted: int
    attribution: dict = field(default_factory=dict)
    episode: str = ""                      # "" -> unperturbed cell
    fork: dict = field(default_factory=dict)   # fork-plan provenance

    def to_json(self) -> dict:
        """Canonical JSON form: recursively sorted keys, numpy scalars
        coerced to Python floats/ints — byte-stable under
        ``json.dumps(..., sort_keys=True)``, which is what the cell
        cache digests and jsonl round-trips key on."""
        return _canonical(asdict(self))

    @classmethod
    def from_json(cls, d: dict) -> "CellStats":
        """Inverse of :meth:`to_json` (unknown keys ignored, so newer
        stores load under older readers and vice versa)."""
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def _canonical(v):
    """Recursively sort dict keys and coerce numpy scalars to plain
    Python so ``json.dumps(..., sort_keys=True)`` of the result is
    byte-stable across numpy versions and insertion orders."""
    if isinstance(v, dict):
        return {str(k): _canonical(v[k]) for k in sorted(v, key=str)}
    if isinstance(v, (list, tuple)):
        return [_canonical(x) for x in v]
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float):
        return float(v)
    return v


def run_replay_cell(cell: ReplayCell) -> CellStats:
    """One full cold replay with a trace recorder attached, scored
    in-process (module-level: spawn-picklable pool worker).  A cell
    with an ``episode`` runs with the :class:`EpisodeWhatIf` policy
    attached from t=0 — the reference trajectory the fork-grouped path
    (:func:`run_cell_group`) must reproduce bit-for-bit."""
    from repro_torch.cluster.scheduler import ClusterSim
    from repro_torch.trace import TraceRecorder

    policy = None
    if cell.episode:
        from repro_torch.ensemble.episodes import EpisodeWhatIf, parse_episode
        policy = EpisodeWhatIf(parse_episode(cell.episode))
    spec = scaled_spec(cell.n_gpus, r_f=cell.r_f)
    recorder = TraceRecorder()
    t0 = time.time()
    sim = ClusterSim(spec, horizon_days=cell.horizon_days, seed=cell.seed,
                     recorder=recorder, scenario=cell.scenario,
                     policy=policy)
    sim.run()
    trace = recorder.finalize(sim)
    stats = score_cell(sim, trace, policy=None, min_gpus=cell.min_gpus,
                       min_hours=cell.min_hours, r_f_nominal=cell.r_f)
    return CellStats(n_gpus=cell.n_gpus, seed=cell.seed,
                     wall_s=round(time.time() - t0, 3),
                     sim_days=cell.horizon_days,
                     episode=cell.episode or "", **stats)


def run_cell_group(cells: Sequence[ReplayCell]) -> list[CellStats]:
    """Every cell of one prefix-sharing group — the unperturbed base
    cell plus episode what-if variants at the same (scale, seed) — via
    the fork plan (``repro_torch.mitigations.forkplan``), module-level so a
    spawn pool can run whole groups as tasks.

    One *carrier* replay runs the shared pre-onset prefix with each
    episode shadowed behind a trap proxy; a snapshot hint lands exactly
    on every onset, so each variant forks at its divergence boundary
    and replays a ~zero-length prefix before perturbing for real.  The
    base cell is scored straight off the carrier's trace (the carrier
    *is* its cold replay).  Output matches ``run_replay_cell`` per
    cell, bit-for-bit, except ``wall_s`` (machine time) and the
    ``fork`` provenance dict."""
    from repro_torch.ensemble.episodes import EpisodeWhatIf, parse_episode

    cells = list(cells)
    base_cfg = replace(cells[0], episode=None)
    for c in cells[1:]:
        if replace(c, episode=None) != base_cfg:
            raise ValueError(
                f"run_cell_group: cells must share everything but "
                f"episode ({replace(c, episode=None)} != {base_cfg})")
    ep_idx = [i for i, c in enumerate(cells) if c.episode]
    if not ep_idx:
        return [run_replay_cell(c) for c in cells]

    from repro_torch.cluster.scheduler import ClusterSim
    from repro_torch.mitigations.forkplan import ForkProbePolicy, fork_cell
    from repro_torch.trace import TraceRecorder

    specs = [parse_episode(cells[i].episode) for i in ep_idx]
    shadows = [EpisodeWhatIf(s) for s in specs]
    # one snapshot per distinct onset, no rolling cadence: every
    # divergence lands on a hint, so periodic snapshots are dead weight
    probe = ForkProbePolicy(
        shadows, snap_period_s=0.0,
        snap_hints_s={s.onset_days * 86400.0 for s in specs})
    spec = scaled_spec(base_cfg.n_gpus, r_f=base_cfg.r_f)
    recorder = TraceRecorder()
    sim = ClusterSim(spec, horizon_days=base_cfg.horizon_days,
                     seed=base_cfg.seed, policy=probe, recorder=recorder,
                     scenario=base_cfg.scenario)
    probe.prepare(sim)
    t0 = time.time()
    sim.run()
    trace = recorder.finalize(sim)
    probe_wall = time.time() - t0

    score_kw = dict(min_gpus=base_cfg.min_gpus, min_hours=base_cfg.min_hours,
                    r_f_nominal=base_cfg.r_f)
    shadow_of = {cell_i: shadow_i for shadow_i, cell_i in enumerate(ep_idx)}
    out = []
    for i, cell in enumerate(cells):
        sh = shadow_of.get(i)
        div = None if sh is None else probe.divergences[sh]
        t1 = time.time()
        if div is None:
            # base cell — or an episode whose onset is past the horizon:
            # the carrier trajectory is this cell's
            cell_sim, cell_trace = sim, trace
            fork_info = {"mode": "shared"}
        else:
            fork = fork_cell(div, shadow_idx=sh,
                             make_policy_fn=lambda s=specs[sh]:
                             EpisodeWhatIf(s))
            fork.run()
            cell_trace = fork.recorder.finalize(fork)
            cell_sim = fork
            fork_info = {
                "mode": "forked",
                "t_fork_days": round(div.cursor_t / 86400.0, 4),
                "replayed_days": round((div.t - div.cursor_t) / 86400.0, 4),
            }
        wall = time.time() - t1
        if i == 0:
            # the first cell carries the shared prefix replay, so summed
            # cell walls stay comparable with the cold path
            fork_info["carries_probe"] = True
            fork_info["probe_wall_s"] = round(probe_wall, 3)
            fork_info["n_snapshots"] = probe.n_snapshots
            wall += probe_wall
        stats = score_cell(cell_sim, cell_trace, policy=None, **score_kw)
        out.append(CellStats(n_gpus=cell.n_gpus, seed=cell.seed,
                             wall_s=round(wall, 3),
                             sim_days=cell.horizon_days,
                             episode=cell.episode or "", fork=fork_info,
                             **stats))
    return out


def grid(gpus_list: Sequence[int], seeds: Sequence[int], *,
         horizon_days: float = 8.0, r_f: float = 6.5e-3,
         min_hours: float = 12.0, scenario: Optional[str] = None,
         episode: Optional[str] = None) -> list[ReplayCell]:
    """The seed x scale grid, scale-major (matches aggregation order)."""
    return [ReplayCell(n_gpus=g, seed=s, horizon_days=horizon_days,
                       r_f=r_f, min_hours=min_hours, scenario=scenario,
                       episode=episode)
            for g in gpus_list for s in seeds]


# ---------------------------------------------------------------------------
# worker-pool executor
# ---------------------------------------------------------------------------
def _indexed_call(arg):
    worker, i, task = arg
    return i, worker(task)


def run_cells(worker: Callable, tasks: Sequence, *, procs: int = 0,
              on_result: Optional[Callable] = None) -> list:
    """Execute ``worker(task)`` for every task, fanning out over a
    ``multiprocessing`` spawn pool when ``procs > 1``.

    Results stream back in *completion* order — ``on_result(i, result)``
    fires as each cell lands, so an aggregator can fold cells online —
    and the returned list is in *task* order regardless.  ``worker`` must
    be a module-level function and tasks picklable (spawn contract).

    spawn, not fork: the host process may hold a CUDA context and torch's
    thread pools (the grid CLIs' analytic bands, pytest), and a forked
    child can use neither; workers only re-import the numpy-level sim
    stack, which never imports torch."""
    n = len(tasks)
    results: list = [None] * n
    if procs and procs > 1 and n > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(min(procs, n)) as pool:
            it = pool.imap_unordered(
                _indexed_call, [(worker, i, t) for i, t in enumerate(tasks)])
            for i, res in it:
                results[i] = res
                if on_result is not None:
                    on_result(i, res)
    else:
        for i, task in enumerate(tasks):
            res = worker(task)
            results[i] = res
            if on_result is not None:
                on_result(i, res)
    return results


def run_grouped_cells(worker, tasks: Sequence, *, procs: int = 0,
                      on_result: Optional[Callable] = None) -> list:
    """``run_cells`` over *group* tasks — each ``worker(task)`` returns a
    **list** of results (e.g. every policy cell at one (scale, seed)
    under the prefix-sharing fork plan, where the group shares one
    probe replay and its snapshots never leave the worker).  Returns the
    flattened results in task order; ``on_result(i, result)`` streams
    each *sub*-result as its group lands, with ``i`` counting delivered
    sub-results in arrival order."""
    delivered = 0

    def _stream(_i, group):
        nonlocal delivered
        for res in group:
            on_result(delivered, res)
            delivered += 1

    groups = run_cells(worker, tasks, procs=procs,
                       on_result=_stream if on_result is not None else None)
    return [res for group in groups for res in group]


def default_procs() -> int:
    """Pool width default: the CPUs this process may actually run on
    (containers/cgroups often pin fewer than ``os.cpu_count`` reports),
    capped at 8."""
    try:
        n = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        n = os.cpu_count() or 1
    return min(n or 1, 8)
