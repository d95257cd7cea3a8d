"""Trace persistence: compressed npz (columnar), jsonl (row-stream), and
chunked spill-part directories (streaming constant-RSS recording).

npz and jsonl round-trip bit-exactly (float64 values survive npz
natively and jsonl via Python's shortest-repr float serialization);
regression-tested in tests/test_trace.py.  npz is the compact archival
format for paper-scale traces; jsonl is grep-able and diff-able for
small ones.

  from repro_torch.trace import io as trace_io
  trace_io.save(trace, "run.npz")       # dispatches on suffix
  trace = trace_io.load("run.npz")
  trace = trace_io.load("spill_dir/")   # chunked spill parts, lazy

A *spill directory* is what ``TraceRecorder(trace_spill_dir=...)``
leaves behind: a ``manifest.json`` (trace meta + per-table part lists)
and ``<table>-NNNN.npz`` part files, each holding one chunk's
schema-dtype columns.  ``load`` returns a ``Trace`` whose tables are
:class:`SpillTable` views — columns are concatenated from the parts
only when first accessed, so opening a paper-scale spill trace is free
and an analysis touches only the columns it needs.  See
``docs/trace_schema.md`` ("Chunked columnar store & spill layout").
"""
from __future__ import annotations

import json
import os
from typing import Iterator, Mapping

import numpy as np

from repro_torch.trace.schema import (OPTIONAL_COLUMNS, TABLES, Trace,
                                      default_column, table_from_columns)

_META_KEY = "__meta__"

SPILL_MANIFEST = "manifest.json"


def save(trace: Trace, path: str) -> str:
    """Write ``trace`` to ``path``; format picked from the suffix
    (``.npz`` or ``.jsonl``).  Returns the path."""
    if path.endswith(".npz"):
        save_npz(trace, path)
    elif path.endswith(".jsonl"):
        save_jsonl(trace, path)
    else:
        raise ValueError(f"unknown trace suffix on {path!r} "
                         "(expected .npz or .jsonl)")
    return path


def load(path: str) -> Trace:
    if os.path.isdir(path):
        return load_spill(path)
    if path.endswith(".npz"):
        return load_npz(path)
    if path.endswith(".jsonl"):
        return load_jsonl(path)
    raise ValueError(f"unknown trace suffix on {path!r} "
                     "(expected .npz, .jsonl, or a spill directory)")


# -- spill directories ---------------------------------------------------
class SpillTable(Mapping):
    """Lazy columnar view over one table's spill parts.

    Quacks like the plain ``{column: ndarray}`` dict the rest of the
    stack consumes (``trace.tables[name][col]``): a column is read and
    concatenated from the part files on first access and cached; row
    count comes from the manifest, so ``Trace.n_rows`` never touches
    disk."""

    def __init__(self, table: str, parts: list[str], rows: int):
        self.table = table
        self.parts = list(parts)
        self.rows = int(rows)
        self._columns = [c for c, _ in TABLES[table]]
        self._cache: dict[str, np.ndarray] = {}

    def __getitem__(self, col: str) -> np.ndarray:
        arr = self._cache.get(col)
        if arr is None:
            if col not in self._columns:
                raise KeyError(col)
            if not self.parts:
                arr = table_from_columns(self.table, {})[col]
            else:
                parts = []
                for path in self.parts:
                    with np.load(path, allow_pickle=False) as z:
                        if col in z.files:
                            parts.append(z[col])
                        elif (self.table, col) in OPTIONAL_COLUMNS:
                            # v1 spill part: synthesize the default fill,
                            # sized off the table's lead column
                            n = len(z[self._columns[0]])
                            parts.append(default_column(self.table, col, n))
                        else:
                            raise KeyError(
                                f"spill part {path!r} missing column {col!r}")
                arr = parts[0] if len(parts) == 1 else np.concatenate(parts)
            self._cache[col] = arr
        return arr

    def __iter__(self) -> Iterator[str]:
        return iter(self._columns)

    def __len__(self) -> int:
        return len(self._columns)

    def __contains__(self, col) -> bool:
        return col in self._columns


def write_spill_manifest(spill_dir: str, meta: dict,
                         tables: dict[str, tuple[list[str], int]]) -> str:
    """``tables`` maps table name -> (part paths, row count); part paths
    are stored relative to the directory so it can be moved/archived."""
    manifest = {
        "meta": meta,
        "tables": {
            name: {"parts": [os.path.basename(p) for p in parts],
                   "rows": rows}
            for name, (parts, rows) in tables.items()},
    }
    path = os.path.join(spill_dir, SPILL_MANIFEST)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def load_spill(spill_dir: str) -> Trace:
    """Open a spill directory as a lazily-loaded ``Trace``."""
    mpath = os.path.join(spill_dir, SPILL_MANIFEST)
    if not os.path.exists(mpath):
        raise ValueError(f"{spill_dir!r} is not a trace spill directory "
                         f"(no {SPILL_MANIFEST})")
    with open(mpath) as f:
        manifest = json.load(f)
    tables = {}
    for name in TABLES:
        info = manifest["tables"].get(name, {"parts": [], "rows": 0})
        parts = [os.path.join(spill_dir, p) for p in info["parts"]]
        tables[name] = SpillTable(name, parts, info["rows"])
    return Trace(manifest["meta"], tables).validate()


# -- npz ----------------------------------------------------------------
def save_npz(trace: Trace, path: str) -> None:
    payload = {_META_KEY: np.array(json.dumps(trace.meta))}
    for name, cols in TABLES.items():
        tbl = trace.tables[name]
        for col, _ in cols:
            if col in tbl:   # optional v2 columns may be absent (v1 trace)
                payload[f"{name}.{col}"] = tbl[col]
    np.savez_compressed(path, **payload)


def load_npz(path: str) -> Trace:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z[_META_KEY][()]))
        tables = {}
        for name, cols in TABLES.items():
            tbl = {}
            for col, _ in cols:
                key = f"{name}.{col}"
                if key in z.files:
                    tbl[col] = z[key]
                elif (name, col) not in OPTIONAL_COLUMNS:
                    raise KeyError(f"{path!r} missing column {key!r}")
            tables[name] = tbl
    return Trace(meta, tables).validate()


# -- jsonl --------------------------------------------------------------
_PY_CAST = {"f8": float, "i8": int, "bool": bool, "str": str}


def save_jsonl(trace: Trace, path: str) -> None:
    with open(path, "w") as f:
        f.write(json.dumps({"meta": trace.meta}) + "\n")
        for name, cols in TABLES.items():
            tbl = trace.tables[name]
            present = [(col, kind) for col, kind in cols if col in tbl]
            casts = [(col, _PY_CAST[kind]) for col, kind in present]
            lists = [tbl[col].tolist() for col, _ in present]
            for row in zip(*lists):
                obj = {"table": name}
                for (col, cast), v in zip(casts, row):
                    obj[col] = cast(v)
                f.write(json.dumps(obj) + "\n")


def load_jsonl(path: str) -> Trace:
    meta = None
    columns: dict[str, dict[str, list]] = {
        name: {col: [] for col, _ in cols} for name, cols in TABLES.items()}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if meta is None:
                meta = obj["meta"]
                continue
            name = obj["table"]
            tbl = columns[name]
            for col in tbl:
                if col in obj:
                    tbl[col].append(obj[col])
                elif (name, col) in OPTIONAL_COLUMNS:
                    # v1 row: fill the default so columns stay rectangular
                    tbl[col].append(OPTIONAL_COLUMNS[(name, col)])
                else:
                    raise KeyError(
                        f"{path!r}: row missing column {col!r} in {name!r}")
    if meta is None:
        raise ValueError(f"{path!r}: empty jsonl trace (no meta line)")
    tables = {name: table_from_columns(name, cols)
              for name, cols in columns.items()}
    return Trace(meta, tables).validate()


def file_size(path: str) -> int:
    return os.path.getsize(path)
