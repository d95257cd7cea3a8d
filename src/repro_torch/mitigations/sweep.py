"""Policy x scale sweep harness over the event-driven cluster simulator.

Runs a grid of (mitigation policy, cluster scale, seed) cells, each a full
``ClusterSim`` replay with the policy plugged into the scheduler hooks, and
reports per-cell ETTR / MTTF / goodput plus deltas vs the baseline policy
at the same (scale, seed) and vs the analytical ``ettr_model`` prediction
(fed the realized interruption rates and queue waits, Fig. 9-style, so the
comparison isolates the checkpoint/restart terms the model actually
captures).  Cells are independent, so the grid fans out over the shared
ensemble executor (``repro_torch.ensemble.runner.run_cells`` — the repo's one
worker-pool implementation) and each cell is scored by the shared
``repro_torch.ensemble.runner.score_cell``.

Every cell runs with a ``repro_torch.trace.TraceRecorder`` attached and scores
its metrics *from the recorded trace* (record trace -> analyze trace, the
trace-layer contract); ``--save-traces DIR`` archives each cell's trace as
npz so any cell can be re-analyzed later with
``python -m repro_torch.trace.report``.

CLI:

  PYTHONPATH=src python -m repro_torch.mitigations.sweep \\
      --policies baseline,lemon_eviction,checkpoint_optimal \\
      --gpus 512,2048,8192 --seeds 2 --days 8 --procs 4 \\
      [--save-traces traces/]

``--analytic-bands`` prints the batched analytical what-if table first:
one ``batch_bands`` call over the policy x scale x seed cube, on the torch
backend one launch of ``kernels/csrc/stat_grid.cu`` on the card
(``--device cpu`` runs its plain version; without a card the run stops
at once).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from collections import defaultdict
from dataclasses import asdict, dataclass, field, fields
from typing import Optional, Sequence

import numpy as np

from repro_torch.cluster.scheduler import ClusterSim
from repro_torch.ensemble.runner import (  # noqa: F401  (re-exported for compat)
    DEFAULT_CP_INTERVAL_S, JOBS_PER_NODE_DAY, U0_S, W_CP_S, default_min_gpus,
    default_procs, run_cells, run_grouped_cells, scaled_spec, score_cell)
from repro_torch.mitigations.policy import make_policy
from repro_torch.trace import TraceRecorder
from repro_torch.trace import io as trace_io

DEFAULT_POLICIES = ("baseline", "lemon_eviction", "checkpoint_optimal")
DEFAULT_GPUS = (512, 2048, 8192)


def model_policy_cell(policy_name: str):
    """The model-side cadence of a registered policy: what the batched
    analytical backend should assume a sweep cell's checkpoint/restart
    knobs are.  Cadence policies map to their static interval (fixed ->
    3600 s, optimal/adaptive -> the Daly-Young optimum the model resolves
    itself via ``dt_cp_s=0``); every other policy runs the runtime's
    default hourly cadence."""
    from repro_torch.core.backend import PolicyCell

    if policy_name in ("checkpoint_optimal", "checkpoint_adaptive"):
        dt = 0.0   # model resolves the Daly-Young optimum per cell
    else:
        dt = DEFAULT_CP_INTERVAL_S
    return PolicyCell(name=policy_name, dt_cp_s=dt, w_cp_s=W_CP_S,
                      u0_s=U0_S)


def analytic_policy_bands(policies: Sequence[str],
                          gpus_list: Sequence[int],
                          seeds: Sequence[int], *,
                          r_f: float = 6.5e-3,
                          runtime_s: float = 7 * 86400.0,
                          backend=None, device=None):
    """Replay-free what-if table: one ``batch_bands`` call over the whole
    (policy x scale x seed) sweep grid at the nominal rate — the instant
    analytical preview of the sweep's checkpoint-cadence axis (policies
    whose effect the closed-form model cannot see, e.g. lemon eviction,
    show up at baseline cadence).  On the TORCH backend that is one
    stat_grid launch on ``device``.  Returns the ``BandGridResult``."""
    from repro_torch.core.backend import BandGrid, batch_bands

    grid = BandGrid(
        gpus=tuple(gpus_list), seeds=tuple(seeds),
        policies=tuple(model_policy_cell(p) for p in policies),
        r_f=r_f, runtime_s=runtime_s,
        job_gpus=tuple(default_min_gpus(g) for g in gpus_list))
    return batch_bands(grid, backend=backend, device=device)


@dataclass
class CellResult:
    """One (policy, scale, seed) grid cell."""

    policy: str
    n_gpus: int
    seed: int
    wall_s: float
    n_records: int
    n_faults: int
    n_infra_failures: int
    n_runs_measured: int
    ettr_sim: float            # mean measured ETTR over qualifying runs
    ettr_model: float          # analytic at realized rates (fig9-style)
    ettr_model_nominal: float  # analytic at the nominal hardware-only r_f
    mttf_large_h: float        # MTTF over qualifying-size jobs, hours
    goodput: float             # (scheduled - failure/preemption loss)/capacity
    n_evicted: int
    extra: dict = field(default_factory=dict)
    trace_path: Optional[str] = None   # npz archive (--save-traces)

    @classmethod
    def from_json(cls, d: dict) -> "CellResult":
        """Rebuild from a cell-cache stats dict (unknown keys ignored)."""
        names = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def _finish_cell(policy_name: str, n_gpus: int, seed: int, sim, trace,
                 policy, wall: float, *, min_gpus: Optional[int],
                 min_hours: float, trace_dir: Optional[str],
                 fork_info: Optional[dict] = None) -> CellResult:
    """Score one replayed cell (cold or forked) into its ``CellResult``
    — the shared back half of ``run_cell`` and ``run_fork_group``."""
    stats = score_cell(sim, trace, policy=policy, min_gpus=min_gpus,
                       min_hours=min_hours, r_f_nominal=sim.spec.r_f)
    extra = {"n_node_events": trace.n_rows("node_events"),
             "n_sched_passes": trace.n_rows("sched_passes"),
             "fitted_r_f": stats["fitted_r_f"]}
    for attr in ("evictions", "activations", "restarts", "gate_log"):
        v = getattr(policy, attr, None)
        if v is not None:
            extra[f"n_{attr}"] = len(v)
    if fork_info is not None:
        extra["fork"] = fork_info
    trace_path = None
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        trace_path = os.path.join(
            trace_dir, f"{policy_name}_{n_gpus}gpu_seed{seed}.npz")
        trace_io.save(trace, trace_path)
    return CellResult(
        policy=policy_name, n_gpus=n_gpus, seed=seed, wall_s=round(wall, 2),
        n_records=stats["n_records"], n_faults=stats["n_faults"],
        n_infra_failures=stats["n_infra_failures"],
        n_runs_measured=stats["n_runs_measured"],
        ettr_sim=stats["ettr_sim"], ettr_model=stats["ettr_model"],
        ettr_model_nominal=stats["ettr_model_nominal"],
        mttf_large_h=stats["mttf_large_h"], goodput=stats["goodput"],
        n_evicted=stats["n_evicted"], extra=extra, trace_path=trace_path)


def run_cell(policy_name: str, n_gpus: int, seed: int, *,
             horizon_days: float = 8.0, min_gpus: Optional[int] = None,
             min_hours: float = 12.0, policy_kwargs: Optional[dict] = None,
             trace_dir: Optional[str] = None,
             scenario: Optional[str] = None,
             r_f: float = 6.5e-3) -> CellResult:
    """One cold-start grid cell: replay with the policy attached from
    t=0, record the trace, and score every metric from it through the
    shared ensemble scorer (optionally archiving the trace as npz under
    ``trace_dir``).  The fork-plan path (``run_fork_group``) must agree
    with this bit-for-bit (regression-tested in tests/test_forking.py)."""
    spec = scaled_spec(n_gpus, r_f=r_f)
    policy = make_policy(policy_name, seed=seed + 9000,
                         **(policy_kwargs or {}))
    recorder = TraceRecorder()
    t0 = time.time()
    sim = ClusterSim(spec, horizon_days=horizon_days, seed=seed,
                     policy=policy, recorder=recorder, scenario=scenario)
    sim.run()
    trace = recorder.finalize(sim)
    wall = time.time() - t0
    return _finish_cell(policy_name, n_gpus, seed, sim, trace, policy,
                        wall, min_gpus=min_gpus, min_hours=min_hours,
                        trace_dir=trace_dir)


def _cell_worker(args) -> CellResult:
    name, n_gpus, seed, kw = args
    return run_cell(name, n_gpus, seed, **kw)


def run_fork_group(policies: Sequence[str], n_gpus: int, seed: int, *,
                   horizon_days: float = 8.0,
                   min_gpus: Optional[int] = None, min_hours: float = 12.0,
                   policy_kwargs: Optional[dict[str, dict]] = None,
                   trace_dir: Optional[str] = None,
                   scenario: Optional[str] = None, r_f: float = 6.5e-3,
                   snap_period_days: float = 1.0) -> list[CellResult]:
    """Every policy cell at one (scale, seed) via the prefix-sharing
    fork plan (``repro_torch.mitigations.forkplan``): one *probe* replay runs
    the shared baseline prefix with each policy shadowed behind a trap
    proxy and rolling snapshots at a ``snap_period_days`` cadence.
    Cells whose policy never intervenes are scored straight off the
    probe trace (their cold trajectory *is* the probe's — near-free);
    each diverging cell forks from the snapshot preceding its first
    intervention and pays only the divergent suffix.  Output is
    identical to running ``run_cell`` per policy, cell for cell, except
    ``wall_s`` (machine time) and the ``extra["fork"]`` provenance
    block (the cell that absorbed the probe carries
    ``carries_probe=True``)."""
    from repro_torch.mitigations.forkplan import ForkProbePolicy, fork_cell

    pk = policy_kwargs or {}
    policies = list(policies)

    def _make(name: str):
        return make_policy(name, seed=seed + 9000, **(pk.get(name) or {}))

    spec = scaled_spec(n_gpus, r_f=r_f)
    shadows = [_make(p) for p in policies]
    probe = ForkProbePolicy(shadows,
                            snap_period_s=snap_period_days * 86400.0)
    recorder = TraceRecorder()
    sim = ClusterSim(spec, horizon_days=horizon_days, seed=seed,
                     policy=probe, recorder=recorder, scenario=scenario)
    probe.prepare(sim)
    t0 = time.time()
    sim.run()
    trace = recorder.finalize(sim)
    probe_wall = time.time() - t0

    # the probe *is* one full baseline replay: its wall lands on the
    # baseline cell when present (first cell otherwise), so summed cell
    # walls stay comparable with the cold path
    carrier = policies.index("baseline") if "baseline" in policies else 0
    kw = dict(min_gpus=min_gpus, min_hours=min_hours, trace_dir=trace_dir)
    out = []
    for idx, name in enumerate(policies):
        div = probe.divergences[idx]
        t1 = time.time()
        if div is None:
            # never intervened: the probe trajectory is this cell's
            cell_sim, cell_trace, policy = sim, trace, shadows[idx]
            fork_info = {"mode": "shared"}
        else:
            fork = fork_cell(div, shadow_idx=idx,
                             make_policy_fn=lambda nm=name: _make(nm))
            fork.run()
            cell_trace = fork.recorder.finalize(fork)
            cell_sim, policy = fork, fork.policy
            fork_info = {
                "mode": "forked",
                "hook": div.hook,
                "t_diverge_days": round(div.t / 86400.0, 4),
                "t_fork_days": round(div.cursor_t / 86400.0, 4),
                "replayed_days": round((div.t - div.cursor_t) / 86400.0, 4),
            }
        wall = time.time() - t1
        if idx == carrier:
            fork_info["carries_probe"] = True
            fork_info["probe_wall_s"] = round(probe_wall, 3)
            fork_info["n_snapshots"] = probe.n_snapshots
            fork_info["snapshot_wall_s"] = round(probe.snapshot_wall_s, 3)
            wall += probe_wall
        out.append(_finish_cell(name, n_gpus, seed, cell_sim, cell_trace,
                                policy, wall, fork_info=fork_info, **kw))
    return out


def _fork_group_worker(args) -> list[CellResult]:
    policies, n_gpus, seed, kw = args
    return run_fork_group(policies, n_gpus, seed, **kw)


@dataclass
class SweepResult:
    cells: list[CellResult]
    horizon_days: float
    wall_s: float = 0.0

    def cell(self, policy: str, n_gpus: int, seed: int
             ) -> Optional[CellResult]:
        for c in self.cells:
            if (c.policy, c.n_gpus, c.seed) == (policy, n_gpus, seed):
                return c
        return None

    def aggregate(self) -> list[dict]:
        """Per (policy, scale): seed-mean metrics + deltas vs baseline."""
        out = []
        for (policy, n_gpus), cells in sorted(
                _group(self.cells).items(),
                key=lambda kv: (kv[0][1], kv[0][0] != "baseline", kv[0][0])):
            base = [self.cell("baseline", n_gpus, c.seed) for c in cells]
            row = {
                "policy": policy, "n_gpus": n_gpus, "n_seeds": len(cells),
                "ettr_sim": _nanmean([c.ettr_sim for c in cells]),
                "ettr_model": _nanmean([c.ettr_model for c in cells]),
                "ettr_model_nominal": _nanmean(
                    [c.ettr_model_nominal for c in cells]),
                "goodput": _nanmean([c.goodput for c in cells]),
                "mttf_large_h": _nanmean(
                    [c.mttf_large_h for c in cells if
                     math.isfinite(c.mttf_large_h)]),
                "n_evicted": sum(c.n_evicted for c in cells),
            }
            if all(b is not None for b in base) and policy != "baseline":
                row["d_ettr"] = _nanmean(
                    [c.ettr_sim - b.ettr_sim for c, b in zip(cells, base)])
                row["d_goodput"] = _nanmean(
                    [c.goodput - b.goodput for c, b in zip(cells, base)])
            out.append(row)
        return out

    def table(self) -> str:
        hdr = (f"{'policy':22s} {'gpus':>6s} {'ETTR':>6s} {'model':>6s} "
               f"{'dETTR':>7s} {'goodput':>7s} {'dgoodp':>7s} "
               f"{'MTTF_h':>8s} {'evict':>5s}")
        lines = [hdr, "-" * len(hdr)]
        for row in self.aggregate():
            lines.append(
                f"{row['policy']:22s} {row['n_gpus']:6d} "
                f"{_fmt(row['ettr_sim'])} {_fmt(row['ettr_model'])} "
                f"{_fmt(row.get('d_ettr'), '+7.3f')} "
                f"{_fmt(row['goodput'], '7.3f')} "
                f"{_fmt(row.get('d_goodput'), '+7.3f')} "
                f"{_fmt(row['mttf_large_h'], '8.1f')} "
                f"{row['n_evicted']:5d}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {"horizon_days": self.horizon_days, "wall_s": self.wall_s,
                "cells": [asdict(c) for c in self.cells],
                "aggregate": self.aggregate()}


def _group(cells: Sequence[CellResult]) -> dict:
    g: dict[tuple, list] = defaultdict(list)
    for c in cells:
        g[(c.policy, c.n_gpus)].append(c)
    for v in g.values():
        v.sort(key=lambda c: c.seed)
    return g


def _nanmean(xs) -> float:
    xs = [x for x in xs if x is not None and not math.isnan(x)]
    return float(np.mean(xs)) if xs else float("nan")


def _fmt(v, spec: str = "6.3f") -> str:
    width = int("".join(c for c in spec.split(".")[0] if c.isdigit()) or 6)
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "-".rjust(width)
    return f"{v:{spec}}"


def sweep(policies: Sequence[str] = DEFAULT_POLICIES,
          gpus_list: Sequence[int] = DEFAULT_GPUS,
          seeds: Sequence[int] = (0, 1), *, horizon_days: float = 8.0,
          min_gpus: Optional[int] = None, min_hours: float = 12.0,
          procs: int = 0,
          policy_kwargs: Optional[dict[str, dict]] = None,
          trace_dir: Optional[str] = None,
          scenario: Optional[str] = None,
          r_f: float = 6.5e-3,
          fork: bool = True, snap_period_days: float = 1.0,
          cache=None, on_result=None) -> SweepResult:
    """Run the policy x scale x seed grid on the shared ensemble executor
    (``procs`` > 1 fans cells out over its spawn pool; 0/1 runs serially
    in-process).  ``fork=True`` (default) executes the grid as
    prefix-sharing groups — per (scale, seed) one probe replay plus
    forked/shared suffix cells (``run_fork_group``); ``fork=False`` is
    the cold-start escape hatch, one full replay per cell.  Both paths
    produce identical cells (wall_s/``extra["fork"]`` aside).
    ``trace_dir`` archives each cell's trace as npz; ``scenario`` names
    a fault-model v2 pack applied to every cell; ``r_f`` the nominal
    per-node-day hardware fault rate; ``on_result(i, cell)`` streams
    each ``CellResult`` as it lands (in completion order — the
    heartbeat/progress channel).

    ``cache`` (a ``repro_torch.ensemble.cellcache.CellCache``) memoizes
    scored cells by content key: hits stream back immediately (marked
    ``extra["cache_hit"]``) and only misses replay — fork groups shrink
    to their missing policies.  Ignored when ``trace_dir`` is set (an
    archived trace must come from a real replay)."""
    kw = dict(horizon_days=horizon_days, min_gpus=min_gpus,
              min_hours=min_hours, trace_dir=trace_dir, scenario=scenario,
              r_f=r_f)
    use_cache = cache is not None and trace_dir is None
    t0 = time.time()
    delivered = 0
    cells: list[CellResult] = []

    def _deliver(c: CellResult) -> None:
        nonlocal delivered
        cells.append(c)
        if on_result is not None:
            on_result(delivered, c)
        delivered += 1

    def _cfg(p: str, g: int, s: int) -> dict:
        from repro_torch.ensemble.cellcache import sweep_config
        return sweep_config(p, g, s, horizon_days=horizon_days,
                            min_gpus=min_gpus, min_hours=min_hours,
                            scenario=scenario, r_f=r_f,
                            policy_kwargs=(policy_kwargs or {}).get(p))

    miss: list[tuple] = []
    for g in gpus_list:
        for s in seeds:
            for p in policies:
                if use_cache:
                    from repro_torch.ensemble.cellcache import config_key
                    rec = cache.lookup(config_key(_cfg(p, g, s),
                                                  kind="sweep"))
                    if rec is not None:
                        c = CellResult.from_json(rec)
                        c.extra = {**c.extra, "cache_hit": True}
                        _deliver(c)
                        continue
                miss.append((p, g, s))

    def _live(_i, c: CellResult) -> None:
        if use_cache:
            from repro_torch.ensemble.cellcache import config_key
            cfg = _cfg(c.policy, c.n_gpus, c.seed)
            cache.store(config_key(cfg, kind="sweep"), "sweep", cfg,
                        asdict(c))
        _deliver(c)

    if fork:
        by_gs: dict[tuple, list] = {}
        for p, g, s in miss:
            by_gs.setdefault((g, s), []).append(p)
        gtasks = [(tuple(ps), g, s,
                   {**kw, "policy_kwargs": policy_kwargs,
                    "snap_period_days": snap_period_days})
                  for (g, s), ps in by_gs.items()]
        run_grouped_cells(_fork_group_worker, gtasks, procs=procs,
                          on_result=_live)
    else:
        tasks = [(p, g, s, {**kw, "policy_kwargs":
                            (policy_kwargs or {}).get(p)})
                 for p, g, s in miss]
        run_cells(_cell_worker, tasks, procs=procs, on_result=_live)
    cells.sort(key=lambda c: (c.n_gpus, c.policy, c.seed))
    return SweepResult(cells, horizon_days, wall_s=time.time() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--policies", default=",".join(DEFAULT_POLICIES),
                    help="comma-separated policy names (see "
                         "repro_torch.mitigations.available_policies)")
    ap.add_argument("--gpus", default=",".join(map(str, DEFAULT_GPUS)),
                    help="comma-separated cluster scales in GPUs")
    ap.add_argument("--seeds", type=int, default=2,
                    help="number of seeds per cell (0..n-1)")
    ap.add_argument("--days", type=float, default=8.0)
    ap.add_argument("--min-hours", type=float, default=12.0,
                    help="min total runtime for an ETTR-qualifying run")
    ap.add_argument("--procs", type=int, default=default_procs())
    ap.add_argument("--scenario", default=None,
                    help="fault-model v2 scenario pack (see "
                         "repro_torch.configs.scenarios; default: exact-legacy "
                         "independent-v1)")
    ap.add_argument("--analytic-bands", action="store_true",
                    help="print the batched analytical what-if table "
                         "(repro_torch.core.backend.batch_bands over the same "
                         "policy x scale grid) before the replay sweep")
    ap.add_argument("--stat-backend", default=None,
                    choices=["numpy", "torch"],
                    help="statistical backend for --analytic-bands "
                         "(default: REPRO_TORCH_STAT_BACKEND or torch)")
    ap.add_argument("--device", default="cuda",
                    help="device of the torch backend's stat_grid launch "
                         "(cpu runs the kernel's plain version)")
    ap.add_argument("--bands-json", default=None, metavar="PATH",
                    help="with --analytic-bands: write the what-if table's "
                         "grid and per-cell arrays, and the stat_grid "
                         "launches of this run, as JSON to PATH")
    ap.add_argument("--r-f", type=float, default=6.5e-3,
                    help="nominal failure rate for --analytic-bands "
                         "(failures per node-day)")
    ap.add_argument("--no-fork", action="store_true",
                    help="disable the prefix-sharing fork plan: run every "
                         "cell cold from t=0 (the escape hatch; output is "
                         "identical up to wall_s/extra['fork'])")
    ap.add_argument("--snap-period-days", type=float, default=1.0,
                    help="rolling-snapshot cadence of the fork plan's "
                         "probe replay (sim days)")
    ap.add_argument("--cache", default=None, metavar="DIR",
                    help="content-addressed cell cache directory (default: "
                         "$REPRO_CELL_CACHE): hits skip the replay, misses "
                         "run and are appended; ignored with --save-traces")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore --cache/$REPRO_CELL_CACHE for this run")
    ap.add_argument("--json", default=None)
    ap.add_argument("--save-traces", default=None, metavar="DIR",
                    help="archive each cell's trace as npz under DIR "
                         "(re-analyzable with python -m repro_torch.trace.report)")
    ap.add_argument("--progress", action="store_true",
                    help="stream per-cell heartbeat lines (completion, "
                         "ETA, pool efficiency) while the grid runs")
    ap.add_argument("--heartbeat", default=None, metavar="PATH",
                    help="also stream heartbeats as jsonl to PATH (view "
                         "with python -m repro_torch.obs.report)")
    args = ap.parse_args(argv)
    if args.scenario is not None:
        from repro_torch.configs.scenarios import get_scenario
        try:
            get_scenario(args.scenario)   # fail fast on a bad name
        except KeyError as e:
            ap.error(e.args[0])

    policies = args.policies.split(",")
    gpus_list = [int(g) for g in args.gpus.split(",")]
    if args.analytic_bands:
        from repro_torch.core.backend import cli_backend
        from repro_torch.ensemble.run import write_bands_json

        res = analytic_policy_bands(
            policies, gpus_list, range(args.seeds), r_f=args.r_f,
            backend=cli_backend(args.stat_backend, args.device),
            device=args.device)
        print(f"batched analytical what-if ({res.backend.name}, "
              f"{res.grid.n_cells} cells in {res.wall_s * 1e3:.1f} ms, "
              f"{res.n_compiled_calls} compiled call(s)):")
        print(res.table())
        write_bands_json(args.bands_json, res)
        print()
    fork = not args.no_fork
    from repro_torch.ensemble.cellcache import open_cache
    cache = open_cache(args.cache, no_cache=args.no_cache)
    if cache is not None and args.save_traces:
        print(f"cell cache {cache.root} ignored: --save-traces needs "
              f"real replays")
    on_result = None
    hb = None
    if args.progress or args.heartbeat:
        from repro_torch.obs import Heartbeat

        # under the fork plan each (scale, seed) group yields exactly one
        # probe-carrying "prefix" cell; the rest are near-free "suffix"
        # cells — declaring the split keeps the ETA steady when the
        # cheap suffixes land first
        n_groups = len(gpus_list) * args.seeds
        phase_totals = ({"prefix": n_groups,
                         "suffix": n_groups * (len(policies) - 1)}
                        if fork and len(policies) > 1 else None)
        hb = Heartbeat(
            total=len(policies) * len(gpus_list) * args.seeds,
            procs=args.procs,
            print_fn=(lambda line: print(f"  {line}", flush=True))
            if args.progress else None,
            jsonl_path=args.heartbeat,
            phase_totals=phase_totals)

        def on_result(i, cell):
            cached = cell.extra.get("cache_hit", False)
            fk = cell.extra.get("fork")
            phase = None
            if cached:
                phase = "cached"
            elif fk is not None:
                phase = "prefix" if fk.get("carries_probe") else "suffix"
            hb.on_cell(f"{cell.policy}/{cell.n_gpus}gpu/s{cell.seed}",
                       0.0 if cached else cell.wall_s, phase=phase,
                       cached=cached if cache is not None else None)

    res = sweep(policies=policies, gpus_list=gpus_list,
                seeds=range(args.seeds), horizon_days=args.days,
                min_hours=args.min_hours, procs=args.procs,
                trace_dir=args.save_traces, scenario=args.scenario,
                fork=fork, snap_period_days=args.snap_period_days,
                cache=cache, on_result=on_result)
    if hb is not None:
        hb.close()
        if args.heartbeat:
            print(f"heartbeats streamed to {args.heartbeat}")
    print(res.table())
    if args.save_traces:
        print(f"per-cell traces saved under {args.save_traces}/")
    print(f"\n{len(res.cells)} cells in {res.wall_s:.1f}s "
          f"(horizon {res.horizon_days:g} days)")
    if cache is not None and not args.save_traces:
        print(f"cell cache {cache.root}: {cache.hits} hits, "
              f"{cache.misses} misses ({len(cache)} cells held)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res.to_json(), f, indent=1)


if __name__ == "__main__":
    main()
