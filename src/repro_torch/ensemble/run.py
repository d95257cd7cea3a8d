"""Ensemble CLI: seed x scale replay grids with streaming band aggregation.

  PYTHONPATH=src python -m repro_torch.ensemble.run \\
      --gpus 1024,4096,16384 --seeds 16 [--days 8] [--procs 8] [--json out]

Each cell is a full engine replay (trace recorded and scored in-worker);
the aggregator folds cells as they stream back and prints per-scale
mean / percentile bands for ETTR, MTTF, goodput, fitted r_f, and the
fault-attribution mix, next to the single-seed analytical predictions
(``ettr_model`` at nominal rates, the MTTF ~ 1/N theory line) the bands
are expected to contain.

What-if *episodes* (``--episodes rf:2.0@4,outage:16@4``) run perturbed
variants of every cell next to the base grid, prefix-shared through
the fork plan: one carrier replay per (scale, seed) runs the common
pre-onset prefix and each variant forks at its onset (``--no-fork``
replays them cold — bit-identical output).  ``--cache DIR`` (or
``$REPRO_CELL_CACHE``) memoizes scored cells content-addressed by
engine version + cell config (``repro_torch.ensemble.cellcache``): warm
repeats answer from the store without replaying.

``--analytic-bands`` adds the replay-free bands of every (scale, seed)
cell at its fitted r_f: one ``batch_bands`` call, on the torch backend
one launch of ``kernels/csrc/stat_grid.cu`` on the card (``--device cpu``
runs its plain version; without a card the run stops before its replays).
The replays stay numpy on the host, in spawned workers that never import
torch.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch.core.ettr_model import ETTRParams, expected_ettr
from repro_torch.core.mttf_model import projected_mttf_hours
from repro_torch.ensemble.aggregate import EnsembleAggregator
from repro_torch.ensemble.runner import (DEFAULT_CP_INTERVAL_S, U0_S, W_CP_S,
                                         ReplayCell, default_procs, grid,
                                         run_cell_group, run_cells,
                                         run_grouped_cells, run_replay_cell)


def analytic_ettr(n_gpus: int, r_f: float, *, job_gpus: int = None,
                  gpus_per_node: int = 8,
                  runtime_s: float = 7 * 86400.0) -> float:
    """The single-seed analytical ``ettr_model`` prediction the ensemble
    band is compared against: nominal rates, hourly checkpoints, and a
    *qualifying-size* job (the band is over runs >= ``default_min_gpus``
    of the cluster, not over one cluster-sized job)."""
    from repro_torch.ensemble.runner import default_min_gpus

    if job_gpus is None:
        job_gpus = default_min_gpus(n_gpus)
    return expected_ettr(ETTRParams(
        n_nodes=max(1, job_gpus // gpus_per_node), r_f=r_f, w_cp_s=W_CP_S,
        u0_s=U0_S, dt_cp_s=DEFAULT_CP_INTERVAL_S, runtime_s=runtime_s))


# tolerance when checking the analytic prediction against measured/modeled
# ensemble bands — the mitigation-lab regression calibration (seeds
# 0-4): simulated ETTR lands within [model - 0.10, model + 0.05], i.e. the
# model may sit up to 0.10 above the band and 0.05 below it
MODEL_PAD_LO = 0.05
MODEL_PAD_HI = 0.10


def batched_analytic_bands(agg, *, r_f_nominal: float,
                           runtime_s: float = 7 * 86400.0,
                           backend=None, include_mc: bool = False,
                           device=None):
    """Replay-free analytical bands for an ensemble grid: one
    ``repro_torch.core.backend.batch_bands`` call over the aggregator's
    (scale x seed) cells, feeding each cell's *fitted* r_f (the Fig. 9
    method — the model sees the rates the replays actually realized;
    non-finite fits fall back to ``r_f_nominal``) at the ensemble's
    nominal cadence (hourly checkpoints, W_CP_S/U0_S overheads,
    qualifying-size jobs).

    Returns ``({scale: {metric: Band}}, BandGridResult)``.  With the
    TORCH backend the whole grid is one launch of ``stat_grid`` on
    ``device`` (the card unless ``device="cpu"``, which runs its plain
    version) — the instant counterpart of the replay bands it is compared
    against."""
    from repro_torch.core.backend import BandGrid, PolicyCell, batch_bands
    from repro_torch.ensemble.runner import default_min_gpus

    scales = agg.scales()
    seeds = agg.seeds()
    if not scales:
        raise ValueError("empty ensemble: no cells to band")
    rf = np.full((len(scales), len(seeds)), r_f_nominal, dtype=np.float64)
    for si, g in enumerate(scales):
        by_seed = {c.seed: c for c in agg.cells_at(g)}
        for ki, s in enumerate(seeds):
            c = by_seed.get(s)
            if (c is not None and np.isfinite(c.fitted_r_f)
                    and c.fitted_r_f > 0):
                rf[si, ki] = c.fitted_r_f
    grid = BandGrid(
        gpus=tuple(scales), seeds=tuple(seeds),
        policies=(PolicyCell(name="ensemble-nominal",
                             dt_cp_s=DEFAULT_CP_INTERVAL_S,
                             w_cp_s=W_CP_S, u0_s=U0_S),),
        r_f=rf, runtime_s=runtime_s,
        job_gpus=tuple(default_min_gpus(g) for g in scales))
    res = batch_bands(grid, backend=backend, include_mc=include_mc,
                      device=device)
    return {g: res.bands(0, si) for si, g in enumerate(scales)}, res


def oracle_bracket(agg, bands_by_scale, n_gpus: int, *,
                   metric: str = "ettr_model_nominal"):
    """Oracle-bracketing contract: the event-driven engine is the exact
    oracle, and the batched analytical bands must bracket its ensemble
    band — ``agg.bands(n_gpus)[metric].mean`` must fall inside the
    batched ETTR band padded by that calibration (the engine's
    realized queue/runtime terms pull it up to ``MODEL_PAD_HI`` below
    the nominal-cadence model and ``MODEL_PAD_LO`` above it).

    Returns ``(ok, engine_mean, batched_band)``; ``ok`` is None when the
    engine band is empty (no qualifying runs to bracket)."""
    eng = agg.bands(n_gpus)[metric]
    ab = bands_by_scale[n_gpus]["ettr"]
    if not eng.n:
        return None, float("nan"), ab
    ok = ab.lo - MODEL_PAD_HI <= eng.mean <= ab.hi + MODEL_PAD_LO
    return ok, eng.mean, ab


def write_bands_json(path, res) -> None:
    """Print this process's stat_grid launches when ``res`` (a
    ``BandGridResult``) came from the TORCH tier, and write ``res`` with
    them to ``path`` when one is given."""
    launches = 0
    if res.backend.name == "TORCH":
        from repro_torch.kernels import stat_grid

        launches = stat_grid.launches
        print(f"stat_grid launches: {launches}")
    if path:
        with open(path, "w") as f:
            json.dump({**res.to_json(), "stat_grid_launches": launches}, f)
        print(f"wrote {path}")


def run_ensemble_grid(gpus_list, seeds, *, horizon_days: float = 8.0,
                      r_f: float = 6.5e-3, min_hours: float = 12.0,
                      procs: int = 0, on_result=None, scenario: str = None,
                      episodes=(), fork: bool = True,
                      cache=None) -> dict:
    """Run the (scale x seed [x episode]) grid and fold streaming
    results into one :class:`EnsembleAggregator` per episode variant —
    key ``""`` is the unperturbed base grid, episode keys are canonical
    spec tokens (``repro_torch.ensemble.episodes``).

    ``cache`` (a ``repro_torch.ensemble.cellcache.CellCache``) is consulted
    first: hits stream straight into their aggregator (the aggregator's
    order-independence makes mixing cached and live cells safe) and
    only misses are scheduled on the pool; every live result is
    appended back.  With episodes and ``fork=True`` the live cells run
    as prefix-sharing groups per (scale, seed)
    (:func:`repro_torch.ensemble.runner.run_cell_group`); ``fork=False`` is
    the cold escape hatch — bit-identical output, cell for cell.

    ``on_result(i, stats, done, total, cached)`` streams every cell
    (cached or live) in completion order."""
    from repro_torch.ensemble.episodes import parse_episode

    labels = [""]
    for tok in episodes:
        lab = parse_episode(tok).label()
        if lab not in labels:
            labels.append(lab)
    cells = [ReplayCell(n_gpus=g, seed=s, horizon_days=horizon_days,
                        r_f=r_f, min_hours=min_hours, scenario=scenario,
                        episode=lab or None)
             for g in gpus_list for s in seeds for lab in labels]
    aggs = {lab: EnsembleAggregator() for lab in labels}
    total = len(cells)
    done = 0

    def _fold(stats, cached):
        nonlocal done
        done += 1
        aggs[stats.episode].add(stats)
        if on_result is not None:
            on_result(done - 1, stats, done, total, cached)

    live = []
    for c in cells:
        hit = cache.get_cell(c) if cache is not None else None
        if hit is not None:
            _fold(hit, True)
        else:
            live.append(c)

    by_coord = {(c.n_gpus, c.seed, c.episode or ""): c for c in live}

    def _fold_live(_i, stats):
        if cache is not None:
            cache.put_cell(
                by_coord[(stats.n_gpus, stats.seed, stats.episode)], stats)
        _fold(stats, False)

    if fork and any(c.episode for c in live):
        groups: dict = {}
        for c in live:
            groups.setdefault((c.n_gpus, c.seed), []).append(c)
        run_grouped_cells(run_cell_group, list(groups.values()),
                          procs=procs, on_result=_fold_live)
    else:
        run_cells(run_replay_cell, live, procs=procs,
                  on_result=_fold_live)
    return aggs


def run_ensemble(gpus_list, seeds, *, horizon_days: float = 8.0,
                 r_f: float = 6.5e-3, min_hours: float = 12.0,
                 procs: int = 0, on_result=None,
                 scenario: str = None) -> EnsembleAggregator:
    """Run the plain grid and fold the streaming results into an
    aggregator (the episode/cache-aware front end is
    :func:`run_ensemble_grid`)."""
    cells = grid(gpus_list, seeds, horizon_days=horizon_days, r_f=r_f,
                 min_hours=min_hours, scenario=scenario)
    agg = EnsembleAggregator()

    def _fold(i, stats):
        agg.add(stats)
        if on_result is not None:
            on_result(i, stats, agg.n_cells, len(cells))

    run_cells(run_replay_cell, cells, procs=procs, on_result=_fold)
    return agg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", default="1024,4096,16384",
                    help="comma-separated cluster scales in GPUs")
    ap.add_argument("--seeds", type=int, default=16,
                    help="seeds per scale (0..n-1)")
    ap.add_argument("--days", type=float, default=8.0)
    ap.add_argument("--r-f", type=float, default=6.5e-3,
                    help="injected failure rate (failures per node-day)")
    ap.add_argument("--min-hours", type=float, default=12.0,
                    help="min total runtime for an ETTR-qualifying run")
    ap.add_argument("--procs", type=int, default=default_procs())
    ap.add_argument("--scenario", default=None,
                    help="fault-model v2 scenario pack (see "
                         "repro_torch.configs.scenarios; default: exact-legacy "
                         "independent-v1)")
    ap.add_argument("--episodes", default=None,
                    help="comma-separated what-if episodes run next to the "
                         "base grid (rf:FACTOR@DAY scales the fault rate, "
                         "outage:N@DAY removes N nodes); episode cells "
                         "share the pre-onset prefix with the base cell "
                         "via the fork plan")
    ap.add_argument("--no-fork", action="store_true",
                    help="run every episode cell cold from t=0 instead of "
                         "forking at its onset (the escape hatch; output "
                         "is identical up to wall_s and fork provenance)")
    ap.add_argument("--cache", default=None, metavar="DIR",
                    help="content-addressed cell cache directory (default: "
                         "$REPRO_CELL_CACHE): hits skip the replay, "
                         "misses run and are appended")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore --cache/$REPRO_CELL_CACHE for this run")
    ap.add_argument("--analytic-bands", action="store_true",
                    help="also print the replay-free batched analytical "
                         "bands (repro_torch.core.backend.batch_bands fed each "
                         "cell's fitted r_f) next to the replay bands")
    ap.add_argument("--stat-backend", default=None,
                    choices=["numpy", "torch"],
                    help="statistical backend for --analytic-bands "
                         "(default: REPRO_TORCH_STAT_BACKEND or torch)")
    ap.add_argument("--device", default="cuda",
                    help="device of the torch backend's stat_grid launch "
                         "(cpu runs the kernel's plain version)")
    ap.add_argument("--bands-json", default=None, metavar="PATH",
                    help="with --analytic-bands: write the batched bands' "
                         "grid and per-cell arrays, and the stat_grid "
                         "launches of this run, as JSON to PATH")
    ap.add_argument("--json", default=None)
    ap.add_argument("--progress", action="store_true",
                    help="stream per-cell heartbeat lines (completion, "
                         "ETA, pool efficiency) while the grid runs")
    ap.add_argument("--heartbeat", default=None, metavar="PATH",
                    help="also stream heartbeats as jsonl to PATH (view "
                         "with python -m repro_torch.obs.report)")
    args = ap.parse_args(argv)
    backend = None
    if args.analytic_bands:
        from repro_torch.core.backend import cli_backend
        backend = cli_backend(args.stat_backend, args.device)
    if args.scenario is not None:
        from repro_torch.configs.scenarios import get_scenario
        try:
            get_scenario(args.scenario)   # fail fast on a bad name
        except KeyError as e:
            ap.error(e.args[0])

    gpus_list = [int(g) for g in args.gpus.split(",")]
    if len(set(gpus_list)) != len(gpus_list):
        ap.error(f"--gpus has duplicate scales: {args.gpus} "
                 f"(each (scale, seed) cell must be unique)")
    seeds = range(args.seeds)
    episodes = []
    if args.episodes:
        from repro_torch.ensemble.episodes import parse_episode
        try:
            episodes = [parse_episode(tok).label()
                        for tok in args.episodes.split(",")]
        except ValueError as e:
            ap.error(str(e))
    from repro_torch.ensemble.cellcache import open_cache
    cache = open_cache(args.cache, no_cache=args.no_cache)

    on_result = None
    hb = None
    if args.progress or args.heartbeat:
        from repro_torch.obs import Heartbeat

        hb = Heartbeat(
            total=len(gpus_list) * args.seeds * (1 + len(episodes)),
            procs=args.procs,
            print_fn=(lambda line: print(f"  {line}", flush=True))
            if args.progress else None,
            jsonl_path=args.heartbeat)

        def on_result(i, stats, done, total, cached=False):
            ep = f"/{stats.episode}" if stats.episode else ""
            phase = None
            if cached:
                phase = "cached"
            elif stats.fork:
                phase = ("prefix" if stats.fork.get("carries_probe")
                         else "suffix")
            hb.on_cell(f"{stats.n_gpus}gpu/seed{stats.seed}{ep}",
                       0.0 if cached else stats.wall_s, phase=phase,
                       cached=cached if cache is not None else None)

    t0 = time.time()
    aggs = run_ensemble_grid(gpus_list, seeds, horizon_days=args.days,
                             r_f=args.r_f, min_hours=args.min_hours,
                             procs=args.procs, on_result=on_result,
                             scenario=args.scenario, episodes=episodes,
                             fork=not args.no_fork, cache=cache)
    agg = aggs[""]
    wall = time.time() - t0
    if hb is not None:
        hb.close()
        if args.heartbeat:
            print(f"heartbeats streamed to {args.heartbeat}")

    print()
    print(agg.band_table())
    for lab in episodes:
        print()
        print(f"episode {lab}:")
        print(aggs[lab].band_table())
    print()
    n_cells = sum(a.n_cells for a in aggs.values())
    cluster_days = sum(a.rsc1_cluster_days() for a in aggs.values())
    print(f"{n_cells} cells in {wall:.1f}s on {args.procs} procs "
          f"(~{cluster_days / max(wall, 1e-9):.2f} "
          f"RSC-1-cluster-days/s)")
    if cache is not None:
        print(f"cell cache {cache.root}: {cache.hits} hits, "
              f"{cache.misses} misses ({len(cache)} cells held)")
    for g in agg.scales():
        bands = agg.bands(g)
        model = analytic_ettr(g, args.r_f)
        # the single-seed analytical prediction vs the ensemble band of the
        # same model fed each cell's realized queue/runtime terms
        b_ettr = bands["ettr_model_nominal"]
        b_rf = bands["fitted_r_f"]
        in_e = b_ettr.contains(model, pad_lo=MODEL_PAD_LO,
                               pad_hi=MODEL_PAD_HI)
        in_rf = b_rf.contains(args.r_f)
        mttf_at_fit = projected_mttf_hours(g, b_rf.mean) \
            if b_rf.n and b_rf.mean > 0 else float("nan")
        print(f"  {g:6d} GPUs: analytic E[ETTR]={model:.3f} "
              f"{'in' if in_e else 'OUTSIDE'} ensemble band "
              f"[{b_ettr.lo:.3f}, {b_ettr.hi:.3f}]; "
              f"injected r_f={args.r_f:.2e} "
              f"{'in' if in_rf else 'OUTSIDE'} fitted band "
              f"[{b_rf.lo:.2e}, {b_rf.hi:.2e}] "
              f"(MTTF at fitted rate ~{mttf_at_fit:.1f}h)")

    if args.analytic_bands:
        bands, res = batched_analytic_bands(
            agg, r_f_nominal=args.r_f, backend=backend, device=args.device)
        print()
        print(f"batched analytical bands at fitted rates "
              f"({res.backend.name}, {res.grid.n_cells} cells in "
              f"{res.wall_s * 1e3:.1f} ms, "
              f"{res.n_compiled_calls} compiled call(s)):")
        print(res.table())
        for g in agg.scales():
            ok, eng_mean, ab = oracle_bracket(agg, bands, g)
            if ok is not None:
                print(f"  {g:6d} GPUs: engine model-anchored ETTR "
                      f"{eng_mean:.3f} "
                      f"{'bracketed by' if ok else 'OUTSIDE'} batched band "
                      f"[{ab.lo:.3f}, {ab.hi:.3f}] (+pads)")
        write_bands_json(args.bands_json, res)

    if args.json:
        out = agg.to_json()
        out["wall_s"] = wall
        out["procs"] = args.procs
        if episodes:
            out["episodes"] = {lab: aggs[lab].to_json()
                               for lab in episodes}
        if cache is not None:
            out["cache"] = {"root": cache.root, "hits": cache.hits,
                            "misses": cache.misses}
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
