"""Backend-dispatch seam for the statistical layer: numpy | torch; the port
of ``repro.core.backend``.

The statistical objects, the closed-form ETTR / MTTF models
(``ettr_model``, ``mttf_model``) and the Monte-Carlo validator
(``montecarlo``), dispatch through an enum-keyed seam behind their public
functions. ``StatBackend.NUMPY`` is the per-cell float64 reference loop,
as in the reference. ``StatBackend.TORCH`` stands where the reference's
``JAX_VMAP`` does: float32, and a whole seed x scale x policy grid in one
call, which on the card is one launch of ``kernels/csrc/stat_grid.cu``:

  * closed-form ETTR / E[failures] / MTTF / Daly-Young interval of every
    cell at once;
  * the Monte-Carlo attempt chains of every run of every cell, under a
    hand-written Philox4x32-10;
  * ``batch_bands(grid)``, the grid entry point.

Device. The TORCH tier runs on the card unless the caller passes
``device="cpu"``, which runs the kernel's plain version
(``kernels/stat_grid.py::stat_grid_ref``); with no card and no
``device="cpu"`` it raises and never carries on on the CPU. The process
default stays NUMPY; ``REPRO_TORCH_STAT_BACKEND`` (not the reference's
``REPRO_STAT_BACKEND``, which the reference reads and rejects "torch" in)
sets it.

Tolerances (docs/stat_backend.md): the numpy float64 path is the
reference; the TORCH tier runs float32, so the closed form agrees to
~5e-4 relative and the Monte-Carlo in distribution only (other streams:
numpy's ``default_rng(seed)`` per cell against Philox keyed by (seed,
cell_index), ``cell_index`` the cell's (policy, scale) position, as the
reference's ``fold_in``).
"""
from __future__ import annotations

import math
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import stat_grid

SECONDS_PER_DAY = 86400.0
GPUS_PER_NODE = 8


class StatBackend(Enum):
    """Which implementation serves the statistical layer."""

    NUMPY = 0   # float64 per-seed reference (authoritative)
    TORCH = 1   # float32 whole grids, one stat_grid launch on the card


BACKEND_MAPPING: dict[str, StatBackend] = {
    "numpy": StatBackend.NUMPY,
    "torch": StatBackend.TORCH,
}

_ENV_VAR = "REPRO_TORCH_STAT_BACKEND"


def _env_default() -> StatBackend:
    name = os.environ.get(_ENV_VAR, "numpy").strip().lower()
    if name not in BACKEND_MAPPING:
        raise ValueError(
            f"{_ENV_VAR}={name!r} is not a backend; expected one of "
            f"{sorted(BACKEND_MAPPING)}")
    return BACKEND_MAPPING[name]


_current: Optional[StatBackend] = None


def get_backend() -> StatBackend:
    """The process-wide default backend (``REPRO_TORCH_STAT_BACKEND`` env
    var until overridden with :func:`set_backend` / :func:`use_backend`)."""
    global _current
    if _current is None:
        _current = _env_default()
    return _current


def set_backend(backend: "StatBackend | str") -> StatBackend:
    """Set the process-wide default; returns the previous one."""
    global _current
    prev = get_backend()
    _current = resolve_backend(backend)
    return prev


@contextmanager
def use_backend(backend: "StatBackend | str"):
    """Scoped default-backend override (tests, CLI flags)."""
    prev = set_backend(backend)
    try:
        yield get_backend()
    finally:
        set_backend(prev)


def resolve_backend(backend: "StatBackend | str | None") -> StatBackend:
    """Normalize a ``backend=`` argument: enum member, registry name, or
    None (-> the process default)."""
    if backend is None:
        return get_backend()
    if isinstance(backend, StatBackend):
        return backend
    if isinstance(backend, str):
        try:
            return BACKEND_MAPPING[backend.strip().lower()]
        except KeyError:
            raise ValueError(
                f"unknown stat backend {backend!r}; expected one of "
                f"{sorted(BACKEND_MAPPING)}") from None
    raise TypeError(f"backend must be StatBackend | str | None, "
                    f"got {type(backend).__name__}")


def resolve_device(device=None) -> torch.device:
    """The TORCH tier's device: the card unless the caller names another;
    without a card it raises rather than running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the torch stat backend runs on the card; pass "
            "device='cpu' for its plain version")
    return dev


# ---------------------------------------------------------------------------
# grid description
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PolicyCell:
    """One checkpoint/restart policy point of a band grid (the model-side
    mirror of a mitigation policy's cadence knobs)."""

    name: str = "default"
    dt_cp_s: float = 3600.0     # checkpoint interval; 0 -> Daly-Young
    w_cp_s: float = 300.0       # checkpoint write cost (s)
    u0_s: float = 300.0         # restart overhead (s)
    q_s: float = 0.0            # expected queue wait per resubmission (s)


@dataclass(frozen=True)
class BandGrid:
    """A seed x scale x policy grid for :func:`batch_bands`.

    ``r_f`` is a scalar nominal rate or anything broadcastable to shape
    ``(len(gpus), len(seeds))`` — per-(scale, seed) *fitted* rates from
    an engine ensemble is the Fig. 9-style use.  ``job_gpus`` sizes the
    modeled job per scale (default: the ensemble's qualifying size
    ``max(64, gpus // 16)``)."""

    gpus: tuple
    seeds: tuple
    policies: tuple = (PolicyCell(),)
    r_f: object = 6.5e-3
    runtime_s: float = 7 * 86400.0
    gpus_per_node: int = GPUS_PER_NODE
    job_gpus: Optional[tuple] = None
    n_runs: int = 256           # MC runs per cell (include_mc=True)

    def __post_init__(self):
        object.__setattr__(self, "gpus", tuple(int(g) for g in self.gpus))
        object.__setattr__(self, "seeds", tuple(int(s) for s in self.seeds))
        object.__setattr__(self, "policies", tuple(self.policies))
        if not (self.gpus and self.seeds and self.policies):
            raise ValueError("BandGrid needs >=1 gpus, seeds and policies")
        if self.job_gpus is not None:
            jg = tuple(int(j) for j in self.job_gpus)
            if len(jg) != len(self.gpus):
                raise ValueError("job_gpus must have one entry per scale")
            object.__setattr__(self, "job_gpus", jg)

    @property
    def shape(self) -> tuple:
        """(n_policies, n_scales, n_seeds)."""
        return (len(self.policies), len(self.gpus), len(self.seeds))

    @property
    def n_cells(self) -> int:
        p, s, k = self.shape
        return p * s * k

    def resolved_job_gpus(self) -> tuple:
        if self.job_gpus is not None:
            return self.job_gpus
        return tuple(max(64, g // 16) for g in self.gpus)

    def r_f_matrix(self) -> np.ndarray:
        """Per-(scale, seed) failure rates, shape (n_scales, n_seeds)."""
        shape = (len(self.gpus), len(self.seeds))
        return np.ascontiguousarray(
            np.broadcast_to(np.asarray(self.r_f, dtype=np.float64), shape))


@dataclass(frozen=True)
class Band:
    """Seed-axis band of one metric at one (policy, scale) cell group."""

    metric: str
    n: int
    mean: float
    std: float
    p5: float
    p50: float
    p95: float
    lo: float
    hi: float

    def contains(self, x: float, *, pad_lo: float = 0.0,
                 pad_hi: float = 0.0) -> bool:
        if not (self.n and math.isfinite(x)):
            return False
        return self.lo - pad_lo <= x <= self.hi + pad_hi


def _band(metric: str, values: np.ndarray) -> Band:
    vals = np.asarray(values, dtype=np.float64)
    vals = vals[np.isfinite(vals)]
    if not len(vals):
        nan = float("nan")
        return Band(metric, 0, nan, nan, nan, nan, nan, nan, nan)
    p5, p50, p95 = (float(p) for p in np.percentile(vals, (5.0, 50.0, 95.0)))
    return Band(metric, int(len(vals)), float(vals.mean()),
                float(vals.std(ddof=1)) if len(vals) > 1 else 0.0,
                p5, p50, p95, float(vals.min()), float(vals.max()))


@dataclass
class BandGridResult:
    """Per-cell arrays (policy, scale, seed) + seed-axis band views."""

    grid: BandGrid
    backend: StatBackend
    n_compiled_calls: int       # device executions used (TORCH: 1)
    ettr: np.ndarray            # analytic E[ETTR], shape (P, S, K)
    n_failures: np.ndarray      # analytic E[failures over the run]
    mttf_hours: np.ndarray      # cluster MTTF = (N r_f)^-1, shape (S, K)
    dt_s: np.ndarray            # resolved checkpoint interval (P, S, K)
    mc_ettr_mean: Optional[np.ndarray] = None    # (P, S, K) when include_mc
    mc_ettr_std: Optional[np.ndarray] = None
    mc_n_failures: Optional[np.ndarray] = None
    wall_s: float = 0.0

    def bands(self, policy_idx: int = 0, scale_idx: int = 0
              ) -> dict[str, Band]:
        """Seed-axis bands for one (policy, scale) cell group."""
        out = {
            "ettr": _band("ettr", self.ettr[policy_idx, scale_idx]),
            "n_failures": _band("n_failures",
                                self.n_failures[policy_idx, scale_idx]),
            "mttf_hours": _band("mttf_hours", self.mttf_hours[scale_idx]),
        }
        if self.mc_ettr_mean is not None:
            out["mc_ettr"] = _band(
                "mc_ettr", self.mc_ettr_mean[policy_idx, scale_idx])
        return out

    def table(self) -> str:
        """Per-(policy, scale) analytic band table (seed axis collapsed)."""
        hdr = (f"{'policy':20s} {'gpus':>7s} {'E[ETTR]':>8s} "
               f"{'[lo, hi]':>16s} {'E[fails]':>9s} {'MTTF_h':>9s}")
        lines = [hdr, "-" * len(hdr)]
        for pi, pol in enumerate(self.grid.policies):
            for si, g in enumerate(self.grid.gpus):
                b = self.bands(pi, si)
                e, f, m = b["ettr"], b["n_failures"], b["mttf_hours"]
                lines.append(
                    f"{pol.name:20s} {g:7d} {e.mean:8.3f} "
                    f"[{e.lo:6.3f}, {e.hi:6.3f}] {f.mean:9.1f} "
                    f"{m.mean:9.1f}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# flat cell parameter extraction (shared by both backends)
# ---------------------------------------------------------------------------

def _flat_cells(grid: BandGrid) -> dict[str, np.ndarray]:
    """Flatten the (policy, scale, seed) grid into per-cell parameter
    columns, policy-major then scale then seed — the cell order that
    defines both the Philox key's cell_index and result reshapes."""
    P, S, K = grid.shape
    job_nodes = np.array(
        [max(1, j // grid.gpus_per_node) for j in grid.resolved_job_gpus()],
        dtype=np.float64)
    cluster_nodes = np.array(
        [max(1, g // grid.gpus_per_node) for g in grid.gpus],
        dtype=np.float64)
    rf = grid.r_f_matrix()                       # (S, K)
    pol = grid.policies

    def tile_policy(vals):
        # (P,) -> (P, S, K) flat
        return np.repeat(np.asarray(vals, dtype=np.float64), S * K)

    return {
        "n_nodes": np.tile(np.repeat(job_nodes, K), P),
        "cluster_nodes": cluster_nodes,          # (S,) — MTTF only
        "r_f": np.tile(rf.reshape(-1), P),
        "dt_cp_s": tile_policy([p.dt_cp_s for p in pol]),
        "w_cp_s": tile_policy([p.w_cp_s for p in pol]),
        "u0_s": tile_policy([p.u0_s for p in pol]),
        "q_s": tile_policy([p.q_s for p in pol]),
        "seeds": np.tile(np.asarray(grid.seeds, dtype=np.uint32), P * S),
        "cell_index": np.repeat(np.arange(P * S, dtype=np.uint32), K),
    }


# ---------------------------------------------------------------------------
# the TORCH tier (float32; one stat_grid launch a grid on the card)
# ---------------------------------------------------------------------------

def _tensors(cols: dict, cluster_rate, runtime_s: float, dev) -> tuple[dict, torch.Tensor, dict]:
    """Flat f64 columns as ``kernels.stat_grid`` takes them on ``dev``: f32
    parameter columns and cluster rates, int32 key words, and its keyword
    arguments (runtime_s rounded to f32, and has_queue)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def word(a):  # uint32 words as int32 of the same bits
        return torch.as_tensor(np.asarray(a, dtype=np.uint32).view(np.int32), device=dev)

    tcols = {k: f32(cols[k]) for k in stat_grid.COLUMNS}
    tcols.update({k: word(cols[k]) for k in stat_grid.KEYS})
    kw = dict(runtime_s=float(np.float32(runtime_s)),
              has_queue=bool(np.any(np.asarray(cols["q_s"]) > 0)))
    return tcols, f32(cluster_rate), kw


def grid_columns(grid: BandGrid, device=None) -> tuple[dict, torch.Tensor, dict]:
    """``grid`` as the TORCH tier hands it to ``kernels.stat_grid``: its
    flat columns, its (scale, seed) cluster rates and the keyword arguments
    (add include_mc and n_runs for the Monte-Carlo)."""
    cols = _flat_cells(grid)
    rate = (cols["cluster_nodes"][:, None] * grid.r_f_matrix()).reshape(-1)
    return _tensors(cols, rate, grid.runtime_s, resolve_device(device))


def _grid_call(cols: dict, cluster_rate: np.ndarray, *, runtime_s: float,
               include_mc: bool, n_runs: int, device) -> tuple[dict, int]:
    """Run ``kernels.stat_grid`` over flat f64 columns on ``device``;
    returns its outputs as f64 numpy arrays and the launches it took (1 on
    the card; on the CPU, one call of the plain version)."""
    dev = resolve_device(device)
    tcols, rate, kw = _tensors(cols, cluster_rate, runtime_s, dev)
    before = stat_grid.launches
    out = stat_grid.stat_grid(tcols, rate, include_mc=include_mc, n_runs=n_runs, **kw)
    calls = stat_grid.launches - before if dev.type == "cuda" else 1
    return {k: v.cpu().numpy().astype(np.float64) for k, v in out.items()}, calls


def _scalar_cell(p, device) -> dict:
    """One cell's closed form through the grid kernel."""
    out, _ = _grid_call(
        {"n_nodes": [p.n_nodes], "r_f": [p.r_f], "u0_s": [p.u0_s],
         "w_cp_s": [p.w_cp_s], "q_s": [p.q_s], "dt_cp_s": [p.dt_cp_s],
         "seeds": [0], "cell_index": [0]},
        np.zeros(0), runtime_s=p.runtime_s, include_mc=False, n_runs=0,
        device=device)
    return out


def torch_expected_ettr(p, *, device=None) -> float:
    """TORCH impl behind ettr_model.expected_ettr (float32)."""
    return float(_scalar_cell(p, device)["ettr"][0])


def torch_expected_n_failures(p, *, device=None) -> float:
    """TORCH impl behind ettr_model.expected_n_failures (float32)."""
    return float(_scalar_cell(p, device)["n_failures"][0])


def torch_projected_mttf_hours(n_gpus, r_f, *, device=None) -> float:
    """TORCH impl behind mttf_model.projected_mttf_hours (plain PyTorch,
    float32)."""
    dev = resolve_device(device)
    n_nodes = max(1, int(n_gpus) // GPUS_PER_NODE)
    rate = torch.tensor([n_nodes * r_f], dtype=torch.float32, device=dev)
    return float(stat_grid.mttf_ref(rate)[0])


def torch_ettr_contour(r_f_grid, w_cp_grid_s, *, n_nodes: int, u0_s: float,
                       runtime_s: float, device=None):
    """TORCH impl behind ettr_model.ettr_contour: the whole (w_cp x r_f)
    Daly-Young contour in one grid call. Returns (E, DT), float64."""
    W, R = np.meshgrid(np.asarray(w_cp_grid_s, dtype=np.float64),
                       np.asarray(r_f_grid, dtype=np.float64),
                       indexing="ij")
    n = W.size
    out, _ = _grid_call(
        {"n_nodes": np.full(n, float(n_nodes)), "r_f": R.reshape(-1),
         "u0_s": np.full(n, u0_s), "w_cp_s": W.reshape(-1),
         "q_s": np.zeros(n), "dt_cp_s": np.zeros(n),
         "seeds": np.zeros(n), "cell_index": np.zeros(n)},
        np.zeros(0), runtime_s=runtime_s, include_mc=False, n_runs=0,
        device=device)
    return out["ettr"].reshape(W.shape), out["dt_s"].reshape(W.shape)


def torch_simulate_run_ettr(p, *, n_runs: int, seed: int, device=None):
    """TORCH impl behind montecarlo.simulate_run_ettr: a one-cell batch of
    the grid kernel (key (seed, 0))."""
    grid = BandGrid(
        gpus=(p.n_nodes * GPUS_PER_NODE,), seeds=(seed,),
        policies=(PolicyCell(name="cell", dt_cp_s=p.dt_cp_s,
                             w_cp_s=p.w_cp_s, u0_s=p.u0_s, q_s=p.q_s),),
        r_f=p.r_f, runtime_s=p.runtime_s,
        job_gpus=(p.n_nodes * GPUS_PER_NODE,), n_runs=n_runs)
    res = batch_bands(grid, backend=StatBackend.TORCH, include_mc=True,
                      device=device)
    return (float(res.mc_ettr_mean[0, 0, 0]),
            float(res.mc_ettr_std[0, 0, 0]),
            float(res.mc_n_failures[0, 0, 0]))


def torch_fit_r_f(n_gpus, n_nodes, run_time_s, is_failure, *,
                  min_gpus: int, device=None) -> float:
    """TORCH impl behind mttf_model.fit_r_f, on pre-extracted job columns
    (the record->column walk stays in Python either way): masked f32 sums
    in plain PyTorch."""
    dev = resolve_device(device)
    qualifies = torch.as_tensor(np.asarray(n_gpus) > min_gpus, device=dev)
    nodes = torch.as_tensor(np.asarray(n_nodes, dtype=np.float32), device=dev)
    run_time = torch.as_tensor(np.asarray(run_time_s, dtype=np.float32), device=dev)
    fail = torch.as_tensor(np.asarray(is_failure, dtype=bool), device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    node_days = float(torch.where(qualifies, nodes * run_time / SECONDS_PER_DAY, zero).sum())
    failures = float(torch.where(qualifies & fail, 1.0, zero).sum())
    if node_days <= 0:
        return float("nan")
    return failures / node_days


# ---------------------------------------------------------------------------
# batch_bands: the grid entry point
# ---------------------------------------------------------------------------

def batch_bands(grid: BandGrid, *, backend: "StatBackend | str | None"
                = None, include_mc: bool = False, device=None) -> BandGridResult:
    """Evaluate every (policy, scale, seed) cell of ``grid``: analytic
    E[ETTR] / E[failures] / resolved checkpoint interval per cell and
    cluster MTTF per (scale, seed), plus the Monte-Carlo validator per
    cell when ``include_mc``.

    TORCH evaluates the whole grid (closed form + MC) in **one launch**
    of ``csrc/stat_grid.cu`` on the card (``n_compiled_calls == 1``), or
    in one call of its plain version with ``device="cpu"``; NUMPY is the
    per-seed reference loop over the same cells.
    """
    backend = resolve_backend(backend)
    cols = _flat_cells(grid)
    P, S, K = grid.shape
    shape = (P, S, K)
    rf = grid.r_f_matrix()                        # (S, K)
    cluster_rate = cols["cluster_nodes"][:, None] * rf   # (S, K)
    t0 = time.time()

    if backend is StatBackend.TORCH:
        out, calls = _grid_call(
            cols, cluster_rate.reshape(-1), runtime_s=grid.runtime_s,
            include_mc=include_mc, n_runs=grid.n_runs, device=device)
        mc = {k: out[k].reshape(shape) if include_mc else None
              for k in stat_grid.MC_OUTPUTS}
        return BandGridResult(
            grid=grid, backend=backend, n_compiled_calls=calls,
            ettr=out["ettr"].reshape(shape),
            n_failures=out["n_failures"].reshape(shape),
            mttf_hours=out["mttf_hours"].reshape((S, K)),   # policy-invariant
            dt_s=out["dt_s"].reshape(shape), **mc,
            wall_s=time.time() - t0)

    # -- numpy reference: the historical per-seed loop -------------------
    from repro_torch.core.ettr_model import (ETTRParams, expected_ettr,
                                             expected_n_failures)
    from repro_torch.core.montecarlo import simulate_run_ettr
    from repro_torch.core.mttf_model import projected_mttf_hours

    ettr = np.zeros(shape)
    nf = np.zeros(shape)
    dt_s = np.zeros(shape)
    mc_mean = np.zeros(shape) if include_mc else None
    mc_std = np.zeros(shape) if include_mc else None
    mc_fails = np.zeros(shape) if include_mc else None
    job_nodes = [max(1, j // grid.gpus_per_node)
                 for j in grid.resolved_job_gpus()]
    n_calls = 0
    for pi, pol in enumerate(grid.policies):
        for si in range(S):
            for ki, seed in enumerate(grid.seeds):
                p = ETTRParams(
                    n_nodes=job_nodes[si], r_f=float(rf[si, ki]),
                    u0_s=pol.u0_s, w_cp_s=pol.w_cp_s, q_s=pol.q_s,
                    runtime_s=grid.runtime_s, dt_cp_s=pol.dt_cp_s)
                ettr[pi, si, ki] = expected_ettr(
                    p, backend=StatBackend.NUMPY)
                nf[pi, si, ki] = expected_n_failures(
                    p, backend=StatBackend.NUMPY)
                dt_s[pi, si, ki] = p.resolved_dt_s()
                n_calls += 2
                if include_mc:
                    r = simulate_run_ettr(p, n_runs=grid.n_runs, seed=seed,
                                          backend=StatBackend.NUMPY)
                    mc_mean[pi, si, ki] = r.ettr_mean
                    mc_std[pi, si, ki] = r.ettr_std
                    mc_fails[pi, si, ki] = r.n_failures_mean
                    n_calls += 1
    mttf = np.zeros((S, K))
    for si, g in enumerate(grid.gpus):
        for ki in range(K):
            rate = float(rf[si, ki])
            mttf[si, ki] = (projected_mttf_hours(
                g, rate, backend=StatBackend.NUMPY) if rate > 0
                else float("inf"))
    return BandGridResult(
        grid=grid, backend=backend, n_compiled_calls=n_calls,
        ettr=ettr, n_failures=nf, mttf_hours=mttf, dt_s=dt_s,
        mc_ettr_mean=mc_mean, mc_ettr_std=mc_std, mc_n_failures=mc_fails,
        wall_s=time.time() - t0)
