"""Content-addressed cell cache: memoize deterministic replay cells.

Every replay cell is a pure function of (engine code, cell config,
seed): the engine is bit-deterministic and the scorer is a pure
function of the recorded trace.  So a cell's result can be keyed by
**content** — a sha256 over

  * the *engine-version digest* (``repro_torch.cluster.engine_version``):
    the committed ``ENGINE_DIGESTS`` bit-identity pins plus a source
    hash over every replay-determining module, and
  * the canonical, sorted-keys JSON of the cell's config (for ensemble
    cells the full ``ReplayCell`` including scenario/episode/seed; for
    sweep cells the policy spec plus grid coordinates), tagged by kind

— and persisted in an append-only ``cells.jsonl`` under the cache
directory.  Invalidation is automatic: any engine/source/config drift
changes the key, so stale entries are simply never addressed again.
Corrupt lines (a torn write, hand editing) are skipped with a warning;
duplicate keys resolve first-wins (append-only ⇒ the first write is
the oldest complete one).

The store is consulted and appended from the *parent* grid process
only (workers never see it), so a plain append-per-result needs no
cross-process locking.  ``--cache DIR`` on the ensemble and sweep CLIs
(or ``REPRO_CELL_CACHE``) turns it on.
"""
from __future__ import annotations

import hashlib
import json
import os
import warnings
from dataclasses import asdict
from typing import Optional

from repro_torch.ensemble.runner import CellStats, ReplayCell, _canonical

CACHE_ENV = "REPRO_CELL_CACHE"
CACHE_FILE = "cells.jsonl"


def config_key(config: dict, *, kind: str,
               engine: Optional[str] = None) -> str:
    """The content address of one cell: sha256 over the engine-version
    digest, the cell ``kind`` tag, and the canonical config JSON.
    ``engine`` overrides the digest (tests simulating drift)."""
    if engine is None:
        from repro_torch.cluster.engine_version import engine_version_digest
        engine = engine_version_digest()
    payload = json.dumps(_canonical(config), sort_keys=True)
    h = hashlib.sha256()
    h.update(engine.encode())
    h.update(b"\x00")
    h.update(kind.encode())
    h.update(b"\x00")
    h.update(payload.encode())
    return h.hexdigest()


def cell_key(cell: ReplayCell, *, engine: Optional[str] = None) -> str:
    """Content address of an ensemble :class:`ReplayCell`."""
    return config_key(asdict(cell), kind="ensemble", engine=engine)


def sweep_config(policy: str, n_gpus: int, seed: int, *,
                 horizon_days: float, min_gpus, min_hours: float,
                 scenario, r_f: float,
                 policy_kwargs: Optional[dict] = None) -> dict:
    """The canonical config dict of one mitigation-sweep cell (policy
    spec plus grid coordinates) — what :func:`config_key` hashes and
    the store records beside the stats."""
    return {"policy": policy, "policy_kwargs": policy_kwargs or {},
            "n_gpus": n_gpus, "seed": seed, "horizon_days": horizon_days,
            "min_gpus": min_gpus, "min_hours": min_hours,
            "scenario": scenario, "r_f": r_f}


def sweep_key(policy: str, n_gpus: int, seed: int, *,
              engine: Optional[str] = None, **cfg) -> str:
    """Content address of one mitigation-sweep cell."""
    return config_key(sweep_config(policy, n_gpus, seed, **cfg),
                      kind="sweep", engine=engine)


class CellCache:
    """Append-only jsonl store of scored cells, addressed by content key.

    One line per cell::

        {"key": <sha256>, "kind": "ensemble"|"sweep",
         "config": {...}, "stats": {...}}

    ``config`` is stored for operator inspection only — the key is the
    address; lookups never re-derive it from the stored config."""

    def __init__(self, root: str):
        self.root = root
        self.path = os.path.join(root, CACHE_FILE)
        self.hits = 0
        self.misses = 0
        self._mem: dict[str, dict] = {}
        os.makedirs(root, exist_ok=True)
        self._load()

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    key, stats = rec["key"], rec["stats"]
                    if not isinstance(key, str) \
                            or not isinstance(stats, dict):
                        raise TypeError("key/stats of wrong type")
                except (json.JSONDecodeError, KeyError, TypeError) as e:
                    warnings.warn(
                        f"cell cache {self.path}:{lineno}: corrupt line "
                        f"skipped ({e})")
                    continue
                # first-wins: the earliest complete write is canonical
                self._mem.setdefault(key, stats)

    def __len__(self) -> int:
        return len(self._mem)

    # -- raw dict interface (sweep cells, tests) ------------------------
    def lookup(self, key: str) -> Optional[dict]:
        """Stats dict for ``key`` (counts the hit/miss)."""
        stats = self._mem.get(key)
        if stats is None:
            self.misses += 1
        else:
            self.hits += 1
        return stats

    def store(self, key: str, kind: str, config: dict,
              stats: dict) -> None:
        """Append one scored cell (no-op if the key is already held —
        append-only files never rewrite)."""
        if key in self._mem:
            return
        stats = _canonical(stats)
        self._mem[key] = stats
        rec = {"key": key, "kind": kind, "config": _canonical(config),
               "stats": stats}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()

    # -- ensemble-cell convenience --------------------------------------
    def get_cell(self, cell: ReplayCell) -> Optional[CellStats]:
        stats = self.lookup(cell_key(cell))
        return None if stats is None else CellStats.from_json(stats)

    def put_cell(self, cell: ReplayCell, stats: CellStats) -> None:
        self.store(cell_key(cell), "ensemble", asdict(cell),
                   stats.to_json())


def open_cache(arg: Optional[str], *,
               no_cache: bool = False) -> Optional[CellCache]:
    """Resolve the CLI's cache directory: explicit ``--cache DIR``,
    else the ``REPRO_CELL_CACHE`` environment default; ``--no-cache``
    wins over both."""
    if no_cache:
        return None
    root = arg or os.environ.get(CACHE_ENV)
    return CellCache(root) if root else None
