"""Atomic, optionally-async checkpoint manager + Daly-Young pacing (after
``repro.checkpoint.manager``).

Paper linkage (§II-D, Eq. 3, Fig. 10): the checkpoint write overhead w_cp
decides a large job's ETTR.  ``sync`` mode blocks the step loop for the whole
serialization; ``async`` copies the tensors to the host and returns, writing
in a background thread (the step loop pays only the copy).
``CheckpointPolicy`` paces saves at the Daly-Young interval.

The on-disk form is the reference's, so a checkpoint written by either
package restores in the other: one ``<dir>/step_<N>/`` per checkpoint
holding ``arrays.npz`` (leaves keyed by the reference's flatten path, e.g.
``0/groups/0/p0/attn/wq``, ``1/.step``, ``1/.m/embed`` for a (params,
AdamWState) tuple; bf16 stored as uint16 bit patterns) and
``manifest.json`` (dtypes, step, extra such as the data-pipeline step).
Writes go to ``.tmp-`` then ``os.rename``, so a crash never leaves a
half-valid checkpoint, and restore picks the newest complete step.

torch is imported where a tensor is encoded or decoded: the cadence
policies, which the simulator's replay workers evaluate, never load it.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Iterator, Optional

import numpy as np

from repro_torch.core.ettr_model import daly_young_interval_s

_BF16 = "bfloat16"


def _paths(tree: Any, path: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(key, leaf) pairs keyed as jax's tree paths joined with '/': dict keys
    sorted, list and tuple items by index, NamedTuple fields as '.name'."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _paths(tree[key], path + (str(key),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _paths(item, path + (str(i),))
    else:
        yield "/".join(path), tree


def _flatten(tree: Any) -> dict[str, Any]:
    return dict(_paths(tree))


def _rebuild(template: Any, leaves: Iterator) -> Any:
    """``template``'s structure with its leaves taken in ``_paths`` order."""
    if isinstance(template, dict):
        out = {key: _rebuild(template[key], leaves) for key in sorted(template)}
        return {key: out[key] for key in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(item, leaves) for item in template)
    return next(leaves)


def _encode(t: "torch.Tensor", copy: bool = False) -> tuple[np.ndarray, str]:
    """The leaf's host array and dtype name.  ``copy=True`` gives a CPU
    tensor an array of its own: otherwise the array is a view of the
    tensor's storage, which an in-place update (the trainer's donated
    AdamW step) overwrites while an async write is still reading it."""
    import torch

    from repro_torch.models.convert import numpy_from_tensor

    name = _BF16 if t.dtype == torch.bfloat16 else str(t.dtype).replace("torch.", "")
    a = numpy_from_tensor(t)
    return (a.copy() if copy and t.device.type == "cpu" else a), name


def _decode(a: np.ndarray, dtype_name: str) -> "torch.Tensor":
    import torch

    from repro_torch.models.convert import tensor_from_numpy

    return tensor_from_numpy(a) if dtype_name == _BF16 else torch.from_numpy(a)


# threads that read, write and sum a checkpoint's members, in pieces of at
# most IO_CHUNK bytes (one thread's reads, writes or sums fall well short of
# what the host's memory and disk take)
IO_THREADS = 8
IO_CHUNK = 1 << 28


def _pieces(view: memoryview, offset: int) -> Iterator[tuple[memoryview, int]]:
    """``view`` cut into IO_CHUNK pieces, each with its file offset."""
    for i in range(0, len(view), IO_CHUNK):
        yield view[i:i + IO_CHUNK], offset + i


def _pread(fd: int, view: memoryview, offset: int) -> None:
    """Fill ``view`` from the file at ``offset``, in as many reads as it takes."""
    got = 0
    while got < len(view):
        n = os.preadv(fd, [view[got:]], offset + got)
        if not n:
            raise zipfile.BadZipFile("a checkpoint member is cut short")
        got += n


def _pwrite(fd: int, data, offset: int) -> None:
    """Write all of ``data`` at ``offset``, in as many writes as it takes."""
    view = memoryview(data)
    done = 0
    while done < len(view):
        done += os.pwrite(fd, view[done:], offset + done)


def _read_npz(path: pathlib.Path, keys: list) -> dict[str, np.ndarray]:
    """The arrays ``keys`` of the npz at ``path`` (members stored, as
    ``np.savez`` and ``_write_npz`` write them), as ``np.load`` gives them:
    each member read into its own array and its CRC-32 checked as
    ``zipfile`` checks it, the reads and the sums on IO_THREADS threads
    (``np.load`` reads a zip member 256 KiB at a time, at a fraction of the
    disk's rate)."""
    out: dict[str, np.ndarray] = {}
    members = []
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f, \
            ThreadPoolExecutor(IO_THREADS) as pool:
        for key in keys:
            info = zf.getinfo(key + ".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise zipfile.BadZipFile(f"{path}: {info.filename} is compressed; "
                                         f"a checkpoint's members are stored")
            f.seek(info.header_offset)
            local = f.read(30)  # the local header; its name and extra field follow
            start = info.header_offset + 30 + sum(struct.unpack("<HH", local[26:30]))
            f.seek(start)
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f) if version == (1, 0)
                                     else np.lib.format.read_array_header_2_0(f))
            head = f.tell() - start
            f.seek(start)
            header = f.read(head)
            a = np.empty(shape, dtype, order="F" if fortran else "C")
            view = memoryview(a.reshape(-1, order="A")).cast("B")
            if head + len(view) != info.file_size:
                raise zipfile.BadZipFile(f"{path}: {info.filename} holds {info.file_size} "
                                         f"bytes, not the {head + len(view)} its header says")
            members.append((info, header, view, start + head))
            out[key] = a
        for r in [pool.submit(_pread, f.fileno(), *piece) for _, _, view, at in members
                  for piece in _pieces(view, at)]:
            r.result()
        sums = [pool.submit(lambda h, v: zlib.crc32(v, zlib.crc32(h)), header, view)
                for _, header, view, _ in members]
        for (info, *_), crc in zip(members, sums):
            if crc.result() != info.CRC:
                raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r} in {path}")
    return out


def _dos_time(t: float) -> tuple[int, int]:
    """(time, date) in the zip format's DOS fields, as ``zipfile`` stamps them."""
    y, mo, d, h, mi, s = time.localtime(t)[:6]
    return h << 11 | mi << 5 | s // 2, (y - 1980) << 9 | mo << 5 | d


def _write_npz(path: pathlib.Path, arrays: dict[str, np.ndarray]) -> None:
    """The npz ``np.savez(path, **arrays)`` writes: a zip of stored
    ``<key>.npy`` members with zip64 size fields, each member the ``.npy``
    header ``np.save`` writes and the array's bytes in C order, so
    ``np.load`` and ``zipfile`` read it.  Every member's place in the file
    follows from the sizes, so the arrays' bytes are written and their
    CRC-32s summed on IO_THREADS threads at once, and the local headers,
    which hold the sums, after (``np.savez`` sums, copies and writes each
    16 MiB chunk in turn, on one thread).  The central directory and its end
    records are zip64 whatever the sizes."""
    from io import BytesIO

    version = 45  # zip64
    full = 0xFFFFFFFF  # a 32-bit field whose value is in the zip64 extra field
    dos_time, dos_date = _dos_time(time.time())
    members, offset = [], 0
    for key, a in arrays.items():
        a = np.require(a, requirements="C")
        head = BytesIO()
        np.lib.format.write_array_header_1_0(head, np.lib.format.header_data_from_array_1_0(a))
        name, head = (key + ".npy").encode(), head.getvalue()
        data = memoryview(a.reshape(-1)).cast("B")
        members.append((name, head, data, offset))
        offset += 30 + len(name) + 20 + len(head) + len(data)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        with ThreadPoolExecutor(IO_THREADS) as pool:
            sums = [pool.submit(lambda h, v: zlib.crc32(v, zlib.crc32(h)), head, data)
                    for _, head, data, _ in members]
            writes = [pool.submit(_pwrite, fd, *piece) for name, head, data, at in members
                      for piece in _pieces(data, at + 30 + len(name) + 20 + len(head))]
            for w in writes:
                w.result()
            central = []
            for (name, head, data, at), crc in zip(members, sums):
                size = len(head) + len(data)
                _pwrite(fd, struct.pack("<IHHHHHIIIHH", 0x04034B50, version, 0,
                                        zipfile.ZIP_STORED, dos_time, dos_date, crc.result(),
                                        full, full, len(name), 20)
                        + name + struct.pack("<HHQQ", 1, 16, size, size) + head, at)
                central.append(struct.pack(
                    "<IHHHHHHIIIHHHHHII", 0x02014B50, 3 << 8 | version, version, 0,
                    zipfile.ZIP_STORED, dos_time, dos_date, crc.result(), full, full, len(name),
                    28, 0, 0, 0, 0o600 << 16, full)
                    + name + struct.pack("<HHQQQ", 1, 24, size, size, at))
        central = b"".join(central)
        end, n = offset + len(central), len(members)
        _pwrite(fd, central + struct.pack(
            "<IQHHIIQQQQ", 0x06064B50, 44, 3 << 8 | version, version, 0, 0, n, n,
            len(central), offset) + struct.pack("<IIQI", 0x07064B50, 0, end, 1)
            + struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, min(n, 0xFFFF), min(n, 0xFFFF),
                          min(len(central), full), min(offset, full), 0), offset)
    finally:
        os.close(fd)


@dataclass
class CheckpointInfo:
    step: int
    path: pathlib.Path
    wall_time_s: float


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, *, keep: int = 3,
                 async_mode: bool = False):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_mode = async_mode
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        self.write_log: list[CheckpointInfo] = []

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> float:
        """Returns the time the step loop was blocked (the paper's w_cp in
        sync mode; only the copy to the host in async mode)."""
        t0 = time.time()
        # the blocking part: an async write reads its own snapshot of each leaf
        host = {k: _encode(v, copy=self.async_mode) for k, v in _flatten(tree).items()}
        snapshot_s = time.time() - t0
        if self.async_mode:
            self.wait()  # one write in flight at a time
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}), daemon=True)
            self._thread.start()
            return snapshot_s
        self._write(step, host, extra or {})
        return time.time() - t0

    def _write(self, step: int, host: dict, extra: dict) -> None:
        try:
            t0 = time.time()
            final = self.dir / f"step_{step:09d}"
            tmp = self.dir / f".tmp-step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            _write_npz(tmp / "arrays.npz", {k: v for k, (v, _) in host.items()})
            manifest = {
                "step": step,
                "dtypes": {k: d for k, (_, d) in host.items()},
                "extra": extra,
                "written_at": time.time(),
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomicity boundary
            self.write_log.append(CheckpointInfo(step, final, time.time() - t0))
            self._gc()
        except BaseException as e:  # surfaced on next wait()/save()
            self._last_error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> tuple[int, Any, dict]:
        """Restore into the structure of ``template`` (tensors, meta tensors
        will do).  Returns (step, tree of CPU tensors, extra)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        paths = list(_paths(template))
        data = _read_npz(d / "arrays.npz", [key for key, _ in paths])
        leaves = []
        for key, leaf in paths:
            arr = _decode(data.pop(key), manifest["dtypes"][key])
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
            leaves.append(arr)
        return manifest["step"], _rebuild(template, iter(leaves)), manifest.get("extra", {})


@dataclass
class CheckpointPolicy:
    """Daly-Young pacing from job size + cluster failure rate."""

    n_nodes: int
    r_f_per_node_day: float = 6.50e-3
    w_cp_s: float = 60.0
    min_interval_s: float = 10.0
    max_interval_s: float = 4 * 3600.0

    def interval_s(self) -> float:
        dt = daly_young_interval_s(self.n_nodes, self.r_f_per_node_day, self.w_cp_s)
        return float(np.clip(dt, self.min_interval_s, self.max_interval_s))

    def should_save(self, last_save_t: float, now: float) -> bool:
        return (now - last_save_t) >= self.interval_s()


@dataclass
class AdaptiveCheckpointPolicy(CheckpointPolicy):
    """Daly-Young pacing at the *observed* failure rate.

    The nominal ``r_f_per_node_day`` acts as a prior worth
    ``prior_node_days`` of evidence; ``observe`` folds in measured failure
    counts so the interval re-tunes when the realized rate drifts off
    nominal.  With no observations this is exactly ``CheckpointPolicy``.
    """

    prior_node_days: float = 2000.0
    observed_failures: float = 0.0
    observed_node_days: float = 0.0

    def observe(self, n_failures: float, node_days: float) -> None:
        self.observed_failures += n_failures
        self.observed_node_days += node_days

    @property
    def r_f_effective(self) -> float:
        prior_failures = self.r_f_per_node_day * self.prior_node_days
        return (prior_failures + self.observed_failures) / (
            self.prior_node_days + self.observed_node_days)

    def interval_s(self) -> float:
        dt = daly_young_interval_s(self.n_nodes, self.r_f_effective, self.w_cp_s)
        return float(np.clip(dt, self.min_interval_s, self.max_interval_s))
