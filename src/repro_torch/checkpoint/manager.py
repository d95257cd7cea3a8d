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
import threading
import time
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


def _encode(t: "torch.Tensor") -> tuple[np.ndarray, str]:
    import torch

    from repro_torch.models.convert import numpy_from_tensor

    name = _BF16 if t.dtype == torch.bfloat16 else str(t.dtype).replace("torch.", "")
    return numpy_from_tensor(t), name


def _decode(a: np.ndarray, dtype_name: str) -> "torch.Tensor":
    import torch

    from repro_torch.models.convert import tensor_from_numpy

    return tensor_from_numpy(a) if dtype_name == _BF16 else torch.from_numpy(np.array(a))


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
        host = {k: _encode(v) for k, v in _flatten(tree).items()}  # the blocking part
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
            np.savez(tmp / "arrays.npz", **{k: v for k, (v, _) in host.items()})
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
        leaves = []
        with np.load(d / "arrays.npz") as data:
            for key, leaf in _paths(template):
                arr = _decode(data[key], manifest["dtypes"][key])
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
