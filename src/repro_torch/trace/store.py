"""Chunked columnar append stores — the hot-path v3 logging backbone.

A ``ChunkedStore`` accumulates the rows of one repro-trace/v1 table
(``schema.TABLES``) during a simulation run and *is* the table's columns:
rows are staged in a small row buffer and, every ``chunk_rows`` rows,
transposed once into compact per-column numpy arrays (``str`` schema
columns are staged and chunked as ``int32`` vocabulary codes — the
caller owns the vocabulary, usually via an :class:`Interner`).  Finalize
is then a near-free per-column concatenation plus one vectorized
``vocab[codes]`` decode, instead of the v2 path's end-of-run transpose
of millions of row tuples, and a paper-scale replay never holds a
Python object per job/fault.

Why a row-tuple staging buffer instead of per-column list appends: one
C-level tuple pack + one ``list.append`` costs ~0.5 us/row vs ~0.7 us
for eleven scalar appends and ~1.3 us for the v2 ``JobRecord``
dataclass construction (microbenchmarked on the reference CPU); the
chunk transpose amortizes to ~0.15 us/row.  The *persistent*
representation is columnar either way — the staging buffer never
exceeds ``chunk_rows`` rows.

Streaming spill mode: ``spill_to(dir)`` redirects every completed chunk
to an ``<table>-NNNN.npz`` part file (columns already decoded to schema
dtypes) and drops it from RAM, so a full 330-day RSC-1/RSC-2 replay
runs in near-constant RSS.  ``repro_torch.trace.io`` assembles the parts back
into a lazily-loaded ``Trace`` (see ``io.SpillTable`` / ``io.load``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from repro_torch.trace.schema import TABLES

# 64k rows/chunk: large enough that per-chunk transpose overhead
# amortizes below ~0.2 us/row, small enough that the staging buffer and
# the newest chunk stay cache/RAM-friendly (a jobs chunk is ~5.7 MB)
DEFAULT_CHUNK_ROWS = 65536

_NP_DTYPE = {"f8": np.float64, "i8": np.int64, "bool": np.bool_}


class Interner:
    """Hashable-value -> dense int code, with the decoded string per code.

    ``code()`` interns any hashable (a symptom string, a joined-symptom
    tuple) and returns its stable code; ``strings`` holds the schema
    ``str`` cell for each code (for tuple keys the caller passes the
    encoded cell explicitly) and ``raw`` the original value, so
    materialization (``Trace.job_records()`` / ``ClusterSim.records``)
    can rebuild the exact original objects.
    """

    __slots__ = ("_codes", "strings", "raw")

    def __init__(self):
        self._codes: dict = {}
        self.strings: list[str] = []
        self.raw: list = []

    def code(self, value, string: Optional[str] = None) -> int:
        c = self._codes.get(value)
        if c is None:
            c = len(self.strings)
            self._codes[value] = c
            self.strings.append(value if string is None else string)
            self.raw.append(value)
        return c

    def seed(self, values) -> None:
        """Pre-intern ``values`` (stable codes across runs/tables)."""
        for v in values:
            self.code(v)

    def decode_array(self, codes: np.ndarray) -> np.ndarray:
        """Vectorized code -> schema string column."""
        if not len(codes):
            return np.empty(0, dtype="<U1")
        return np.array(self.strings, dtype=np.str_)[codes]

    # -- snapshot/restore (replay forking) -------------------------------
    def snapshot_state(self) -> tuple:
        """Vocabulary state for an engine snapshot (shallow copies: codes
        and strings are immutable once interned)."""
        return (dict(self._codes), list(self.strings), list(self.raw))

    @classmethod
    def from_state(cls, state: tuple) -> "Interner":
        it = cls()
        codes, strings, raw = state
        it._codes = dict(codes)
        it.strings = list(strings)
        it.raw = list(raw)
        return it


class ChunkedStore:
    """Columnar append store for one ``schema.TABLES`` table.

    ``interners`` maps each ``str`` column to the :class:`Interner` (or
    any object with ``decode_array``) that owns its vocabulary; the
    caller appends *codes* for those columns.  ``append`` takes the full
    row tuple in schema column order.
    """

    __slots__ = ("table", "specs", "chunk_rows", "rows", "interners",
                 "_staged", "_chunks", "_spill_dir", "parts", "_part_rows")

    def __init__(self, table: str, *, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 interners: Optional[dict] = None):
        self.table = table
        self.specs = TABLES[table]
        self.chunk_rows = chunk_rows
        self.rows = 0
        self.interners = interners or {}
        self._staged: list[tuple] = []
        self._chunks: list[dict] = []       # dict col -> ndarray (codes raw)
        self._spill_dir: Optional[str] = None
        self.parts: list[str] = []          # spilled part paths, in order
        self._part_rows: list[int] = []

    # -- append hot path -------------------------------------------------
    def append(self, row: tuple) -> None:
        """Append one row (schema column order, str columns as codes)."""
        staged = self._staged
        staged.append(row)
        self.rows += 1
        if len(staged) >= self.chunk_rows:
            self._flush()

    def _flush(self) -> None:
        staged = self._staged
        if not staged:
            return
        n = len(staged)
        cols = zip(*staged)
        chunk = {
            name: np.fromiter(
                col, dtype=np.int32 if kind == "str" else _NP_DTYPE[kind],
                count=n)
            for (name, kind), col in zip(self.specs, cols)
        }
        staged.clear()
        if self._spill_dir is not None:
            self._write_part(chunk, n)
        else:
            self._chunks.append(chunk)

    # -- spill -----------------------------------------------------------
    def spill_to(self, spill_dir: str) -> None:
        """Redirect completed chunks to npz part files under
        ``spill_dir`` (constant-RSS mode).  Must be enabled before any
        chunk completes; already-staged rows simply spill with the next
        flush."""
        if self._chunks:
            raise ValueError(
                f"{self.table}: spill_to() after {self.rows} rows already "
                "chunked in RAM — enable spilling before the run")
        os.makedirs(spill_dir, exist_ok=True)
        self._spill_dir = spill_dir

    def _write_part(self, chunk: dict, n_rows: int) -> None:
        decoded = {name: self._decode(name, kind, chunk[name])
                   for name, kind in self.specs}
        path = os.path.join(self._spill_dir,
                            f"{self.table}-{len(self.parts):04d}.npz")
        # uncompressed: spill throughput matters more than archive size
        # (use trace_io.save(trace, "x.npz") for compressed archival)
        np.savez(path, **decoded)
        self.parts.append(path)
        self._part_rows.append(n_rows)

    @property
    def spilled(self) -> bool:
        return self._spill_dir is not None

    # -- snapshot/restore (replay forking) -------------------------------
    def snapshot_state(self) -> tuple:
        """Copy-on-write position capture for an engine snapshot.

        Completed chunks are immutable after ``_flush`` (appends only
        ever create *new* chunks), so the snapshot shares them by
        reference — a forked store costs two shallow list copies, not a
        columnar copy.  Staged rows are immutable tuples, shared the
        same way.  Spilling stores cannot snapshot: their chunks live in
        part files owned by the original run."""
        if self._spill_dir is not None:
            raise ValueError(
                f"{self.table}: cannot snapshot a spilling store — "
                "snapshot/fork requires in-memory chunks")
        return (self.rows, list(self._chunks), list(self._staged))

    def restore_state(self, state: tuple) -> None:
        """Adopt a ``snapshot_state`` capture (fresh lists; chunk dicts
        stay shared — see ``snapshot_state``)."""
        rows, chunks, staged = state
        self.rows = rows
        self._chunks = list(chunks)
        self._staged = list(staged)

    # -- finalize --------------------------------------------------------
    def _decode(self, name: str, kind: str, arr: np.ndarray) -> np.ndarray:
        if kind != "str":
            return arr
        return self.interners[name].decode_array(arr)

    def finalize_columns(self) -> dict:
        """The table's schema-dtype columns (near-free: per-column
        concat of the chunks + one vectorized vocabulary decode per str
        column).  Idempotent — the staging tail is flushed into the
        chunk list and repeated calls re-concatenate.  In spill mode the
        tail is flushed to a final part and the columns are read back
        from disk (use ``io.SpillTable`` to stay lazy)."""
        self._flush()
        if self.spilled:
            return {name: self.read_column(name) for name, _ in self.specs}
        if not self._chunks:
            from repro_torch.trace.schema import empty_table
            return empty_table(self.table)
        chunks = self._chunks
        if len(chunks) == 1:
            raw = dict(chunks[0])
        else:
            raw = {name: np.concatenate([c[name] for c in chunks])
                   for name, _ in self.specs}
        return {name: self._decode(name, kind, raw[name])
                for name, kind in self.specs}

    def read_column(self, name: str) -> np.ndarray:
        """One schema-dtype column, concatenated across spill parts (or
        chunks when in RAM).  ``_flush()`` first if rows are staged."""
        self._flush()
        kind = dict(self.specs)[name]
        if self.spilled:
            if not self.parts:
                from repro_torch.trace.schema import empty_table
                return empty_table(self.table)[name]
            arrs = []
            for path in self.parts:
                with np.load(path, allow_pickle=False) as z:
                    arrs.append(z[name])
            return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
        if not self._chunks:
            from repro_torch.trace.schema import empty_table
            return empty_table(self.table)[name]
        arr = (self._chunks[0][name] if len(self._chunks) == 1
               else np.concatenate([c[name] for c in self._chunks]))
        return self._decode(name, kind, arr)

    # -- row access (materialization back-path) --------------------------
    def iter_rows(self, start: int = 0):
        """Yield row tuples (str columns as codes) from ``start`` — the
        ``ClusterSim.records`` / ``fault_log`` materialization path,
        including incremental mid-run reads by policies.  Chunks/parts
        wholly before ``start`` are skipped by their row counts without
        being loaded or transposed, so an incremental read pays only for
        the new rows.  Spill parts store decoded strings, so their cells
        are re-interned through the column vocabularies on the way out
        (the spilled materialization path is cold by construction)."""
        pos = 0
        names = [name for name, _ in self.specs]
        if self.spilled:
            encoders = {
                name: {s: i
                       for i, s in enumerate(self.interners[name].strings)}
                for name, kind in self.specs if kind == "str"}
            for path, n in zip(self.parts, self._part_rows):
                if pos + n <= start:
                    pos += n
                    continue
                with np.load(path, allow_pickle=False) as z:
                    lists = [[encoders[name][s] for s in z[name].tolist()]
                             if name in encoders else z[name].tolist()
                             for name in names]
                lo = start - pos
                if lo > 0:
                    lists = [col[lo:] for col in lists]
                yield from zip(*lists)
                pos += n
        else:
            for chunk in self._chunks:
                n = len(chunk[names[0]])
                if pos + n <= start:
                    pos += n
                    continue
                lists = [chunk[name].tolist() for name in names]
                lo = start - pos
                if lo > 0:
                    lists = [col[lo:] for col in lists]
                yield from zip(*lists)
                pos += n
        for row in self._staged[max(start - pos, 0):]:
            yield row
