"""Ensemble engine: many-seed replay grids with streaming aggregation.

The paper's headline projections (MTTF vs. GPU scale §V, ETTR efficacy
bands Fig. 9/12) are statistical claims — one replay is an anecdote; an
*ensemble* of replays over a seed x scale grid gives the mean and the
band.  This package runs those grids on a worker pool and streams each
worker's per-cell stats (scored in-worker from its recorded trace, which
never leaves the worker) into a deterministic band aggregator:

    PYTHONPATH=src python -m repro_torch.ensemble.run \\
        --gpus 1024,4096,16384 --seeds 16

Pieces:
  * ``runner``    — spawn-pool cell executor (``run_cells``), the
    RSC-1-like ``scaled_spec``, ``score_cell`` (the one place a
    replay's trace is turned into ETTR/MTTF/goodput/attribution stats —
    the mitigation sweep scores its cells through it too), and
    ``run_cell_group`` (prefix-sharing episode groups on the fork plan).
  * ``aggregate`` — ``EnsembleAggregator``: order-independent online
    accumulation; bands are bit-identical for any worker count and any
    cell completion order (tests/test_ensemble.py).
  * ``episodes``  — scenario what-if perturbations (``rf:2.0@4``,
    ``outage:16@4``) applied mid-replay through the public helpers.
  * ``cellcache`` — content-addressed cell memoization keyed by engine
    version + canonical cell config (docs/ensemble_cache.md).
  * ``run``       — the CLI front door.
"""
from repro_torch.ensemble.aggregate import EnsembleAggregator, MetricBand
from repro_torch.ensemble.cellcache import CellCache, cell_key, open_cache
from repro_torch.ensemble.episodes import (EpisodeSpec, EpisodeWhatIf,
                                           parse_episode)
from repro_torch.ensemble.runner import (CellStats, ReplayCell, run_cell_group,
                                         run_cells, run_replay_cell, scaled_spec,
                                         score_cell)

__all__ = [
    "CellCache", "CellStats", "EnsembleAggregator", "EpisodeSpec",
    "EpisodeWhatIf", "MetricBand", "ReplayCell", "cell_key", "open_cache",
    "parse_episode", "run_cell_group", "run_cells", "run_replay_cell",
    "scaled_spec", "score_cell",
]
