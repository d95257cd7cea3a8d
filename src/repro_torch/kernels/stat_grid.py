"""Wrapper around the statistical layer's grid kernel (``csrc/stat_grid.cu``),
the port of ``repro/core/backend.py::_grid_kernel``: the closed-form E[ETTR],
E[failures], Daly-Young interval and projected MTTF of every cell of a
policy x scale x seed grid and, with ``include_mc``, the Monte-Carlo ETTR
validator's statistics, in one launch.

``stat_grid_ref`` is its plain version: the same f32 cell arithmetic, term
by term, and the same hand-written Philox4x32-10, in PyTorch ops, with the
runs as a tensor axis and a loop over attempts that drops the runs that
have completed (the numpy reference's shrinking index array; every draw is
a function of its (seed, cell_index) key and (run, attempt, purpose)
counter, so which runs share a step changes no bit). Each tensor op rounds
on its own, as the kernel does, so per-run outcomes agree to the bit; the
divisors are tensors on the input's device, since PyTorch turns a CUDA
tensor's division by a Python number into a product with its reciprocal.

Draws. Each Philox4x32-10 call gives four words, and each word is one
draw: the time-to-failure draw of attempt ``a`` of run ``r`` is word ``a %
4`` at counter (r, a // 4, TTF, 0), the queue draw after a failed attempt
``a`` word ``a % 4`` at (r, a // 4, QUEUE, 0), and the run's initial queue
draw word ``r % 4`` at (r // 4, 0, QUEUE0, 0), all under the key (seed,
cell_index). A draw depends only on its indices.

On CPU tensors ``stat_grid`` returns its plain version; on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SECONDS_PER_DAY = 86400.0
# Philox4x32-10's multipliers and Weyl key increments (Random123)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
MASK32 = 0xFFFFFFFF
# the counter's third word: which draw of an attempt
TTF, QUEUE, QUEUE0 = 0, 1, 2
COLUMNS = ("n_nodes", "r_f", "u0_s", "w_cp_s", "q_s", "dt_cp_s")
KEYS = ("seeds", "cell_index")
OUTPUTS = ("ettr", "n_failures", "dt_s", "mttf_hours")
MC_OUTPUTS = ("mc_ettr_mean", "mc_ettr_std", "mc_n_failures")

# kernel launches since the last reset; the CPU path does not count
launches = 0          # stat_grid
philox_launches = 0   # the known-answer entry
exponential_launches = 0  # the exponential's check entry


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 64-bit product of the 32-bit constant ``m`` and the 32-bit words
    ``x`` (int64) as (hi, lo) words. ``m`` is split into 16-bit halves so
    that no partial product passes 2^48 (x m itself overflows int64)."""
    a = x * (m & 0xFFFF)
    b = x * (m >> 16)
    mid = ((b & 0xFFFF) << 16) + a
    return (b >> 16) + (mid >> 32), mid & MASK32


def philox4x32_10(ctr, key) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of the counter words ``ctr`` (4) under the key words
    ``key`` (2), each an int64 tensor (or int) of values in [0, 2^32),
    broadcast together; returns the 4 output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for i in range(10):
        if i:
            k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def exponential(x: torch.Tensor) -> torch.Tensor:
    """Standard exponential draws (f32) of Philox words ``x``: -log(u) in
    double with u = ((x >> 8) + 1) 2^-24 in (0, 1], rounded to f32."""
    u = ((x >> 8) + 1).to(torch.float64) * 2.0 ** -24
    return (-torch.log(u)).to(torch.float32)


def exp_draw(k0: torch.Tensor, k1: torch.Tensor, run: torch.Tensor, attempt: int,
             purpose: int) -> torch.Tensor:
    """The attempt's draw of ``purpose`` (TTF or QUEUE) for each run: word
    ``attempt % 4`` at counter (run, attempt // 4, purpose, 0) under key
    (k0, k1)."""
    return exponential(philox4x32_10((run, attempt // 4, purpose, 0), (k0, k1))[attempt % 4])


def first_queue_draw(k0: torch.Tensor, k1: torch.Tensor, run: torch.Tensor) -> torch.Tensor:
    """Each run's initial queue draw: word ``run % 4`` at counter (run // 4,
    0, QUEUE0, 0) under key (k0, k1)."""
    words = torch.stack(philox4x32_10((run // 4, 0, QUEUE0, 0), (k0, k1)))
    return exponential(torch.gather(words, 0, (run % 4)[None]).squeeze(0))


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def closed_form_ref(n_nodes, r_f, u0_s, w_cp_s, q_s, dt_cp_s, runtime_s: float):
    """``_analytic_cell`` in f32, term by term in its order: (E[ETTR],
    E[failures], resolved dt_s, lam_s = failures per second)."""
    spd = _const(SECONDS_PER_DAY, n_nodes)
    lam = n_nodes * r_f
    lam_s = lam / spd
    dt_dy = torch.sqrt((2.0 * w_cp_s) / lam_s.clamp_min(1e-18))
    dt_s = torch.where(dt_cp_s > 0, dt_cp_s, dt_dy)
    d, u0, w, q = dt_s / spd, u0_s / spd, w_cp_s / spd, q_s / spd
    R = _const(runtime_s, n_nodes) / spd
    w_d = torch.where(d > 0, w / torch.where(d > 0, d, torch.ones_like(d)), torch.zeros_like(d))
    num = 1.0 - lam * (u0 + d * 0.5)
    den = ((1.0 + (u0 + q) / R) + w_d) + (lam * q) * ((1.0 + w_d) - d / (2.0 * R))
    bad = num <= 0
    ettr = torch.where(bad, torch.zeros_like(num), torch.clamp(num / den, 0.0, 1.0))
    nf = torch.where(bad, torch.full_like(num, float("inf")),
                     ((R * lam) * ((1.0 + u0 / R) + w_d)) / torch.where(bad, torch.ones_like(num),
                                                                          num))
    return ettr, nf, dt_s, lam_s


def mttf_ref(rate: torch.Tensor) -> torch.Tensor:
    """24 / rate hours where rate > 0, else inf (f32)."""
    return torch.where(rate > 0, torch.full_like(rate, 24.0) / rate.clamp_min(1e-30),
                       torch.full_like(rate, float("inf")))


def monte_carlo_ref(lam_s, dt_s, w_cp_s, u0_s, q_s, seeds, cell_index, runtime_s: float,
                    n_runs: int, has_queue: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Every run's realised ETTR (f32) and failure count (int32), shape
    (cells, n_runs): ``_make_mc_cell``'s attempt process, term by term in
    its order, under ``csrc/stat_grid.cu``'s Philox draws."""
    dev, C = lam_s.device, lam_s.numel()
    idx = torch.arange(C * n_runs, device=dev)
    cell, run = idx // n_runs, idx % n_runs
    k0, k1 = ((k.to(torch.int64) & MASK32)[cell] for k in (seeds, cell_index))
    R_t = _const(runtime_s, lam_s)
    productive = torch.zeros(C * n_runs, dtype=torch.float32, device=dev)
    unproductive = torch.zeros_like(productive)
    queue = torch.zeros_like(productive)
    fails = torch.zeros(C * n_runs, dtype=torch.int32, device=dev)
    if has_queue:
        queue = first_queue_draw(k0, k1, run) * q_s[cell]
    active, attempt = idx, 0
    while active.numel():
        c = cell[active]
        lam, dt, w, u0 = lam_s[c], dt_s[c], w_cp_s[c], u0_s[c]
        free_cp = dt <= 0  # the w_cp = 0 Daly-Young limit
        dt_safe = torch.where(free_cp, torch.ones_like(dt), dt)
        R_rem = R_t - productive[active]
        m = torch.where(free_cp, torch.zeros_like(dt),
                        (torch.ceil(R_rem / dt_safe) - 1.0).clamp_min(0.0))
        mw = m * w
        t_done = (u0 + R_rem) + mw
        draw = exp_draw(k0[active], k1[active], run[active], attempt, TTF)
        ttf = torch.where(lam > 0, draw / lam.clamp_min(1e-30), torch.full_like(lam, float("inf")))
        comp = ttf > t_done
        prog = torch.where(
            free_cp, torch.minimum((ttf - u0).clamp_min(0.0), R_rem),
            torch.minimum(torch.floor((ttf - u0) / (dt_safe + w)).clamp_min(0.0), m) * dt_safe)
        productive[active] = torch.where(comp, R_t, productive[active] + prog)
        unproductive[active] = unproductive[active] + torch.where(
            comp, u0 + mw, torch.maximum(ttf, u0) - prog)
        failed = active[~comp]
        if has_queue and failed.numel():
            queue[failed] = queue[failed] + exp_draw(
                k0[failed], k1[failed], run[failed], attempt, QUEUE) * q_s[cell[failed]]
        fails[failed] += 1
        active, attempt = failed, attempt + 1
    ettr = productive / ((productive + unproductive) + queue)
    return ettr.view(C, n_runs), fails.view(C, n_runs)


def cell_stats(run_ettr: torch.Tensor, run_fails: torch.Tensor, shift: torch.Tensor):
    """A cell's mean and population std of ETTR and its mean failures, in
    double, from sums shifted by ``shift`` (the cell's closed-form E[ETTR])
    as the kernel takes them."""
    n = run_ettr.shape[1]
    d = run_ettr.to(torch.float64) - shift.to(torch.float64)[:, None]
    m1 = d.sum(1) / n
    var = ((d * d).sum(1) / n - m1 * m1).clamp_min(0.0)
    return shift.to(torch.float64) + m1, var.sqrt(), run_fails.to(torch.float64).sum(1) / n


def _check(cols: dict, cluster_rate: torch.Tensor, include_mc: bool, n_runs: int) -> None:
    dev = cols["n_nodes"].device
    n = cols["n_nodes"].numel()
    if n == 0:
        raise ValueError("stat_grid needs at least one cell")
    for name in COLUMNS:
        t = cols[name]
        if t.dtype != torch.float32 or t.dim() != 1 or t.numel() != n or t.device != dev:
            raise ValueError(f"{name} must be f32 of shape ({n},) on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name in KEYS:
        t = cols[name]
        if t.dtype != torch.int32 or t.dim() != 1 or t.numel() != n or t.device != dev:
            raise ValueError(f"{name} must be int32 of shape ({n},) on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if (cluster_rate.dtype != torch.float32 or cluster_rate.dim() != 1
            or cluster_rate.numel() > n or cluster_rate.device != dev):
        raise ValueError(f"cluster_rate must be f32 of at most {n} entries on {dev}")
    if include_mc and n_runs <= 0:
        raise ValueError(f"the Monte-Carlo needs n_runs >= 1; got {n_runs}")
    if n * max(n_runs, 1) >= 2 ** 31:
        raise ValueError("cells x runs must stay below 2^31")


def stat_grid_ref(cols: dict, cluster_rate: torch.Tensor, *, runtime_s: float,
                  include_mc: bool = False, n_runs: int = 0, has_queue: bool = False,
                  runs: bool = False) -> dict:
    """The plain version of ``stat_grid`` (same arguments and outputs)."""
    _check(cols, cluster_rate, include_mc, n_runs)
    ettr, nf, dt_s, lam_s = closed_form_ref(*(cols[k] for k in COLUMNS), runtime_s)
    out = {"ettr": ettr, "n_failures": nf, "dt_s": dt_s, "mttf_hours": mttf_ref(cluster_rate)}
    if include_mc:
        run_ettr, run_fails = monte_carlo_ref(
            lam_s, dt_s, cols["w_cp_s"], cols["u0_s"], cols["q_s"], cols["seeds"],
            cols["cell_index"], runtime_s, n_runs, has_queue)
        out.update(zip(MC_OUTPUTS, cell_stats(run_ettr, run_fails, ettr)))
        if runs:
            out["run_ettr"], out["run_fails"] = run_ettr, run_fails
    return out


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) as int32 tensors of the same bits."""
    if bool(((t < 0) | (t > MASK32)).any()):
        raise ValueError("words must lie in [0, 2^32)")
    return torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32).contiguous()


def stat_grid(cols: dict, cluster_rate: torch.Tensor, *, runtime_s: float,
              include_mc: bool = False, n_runs: int = 0, has_queue: bool = False,
              runs: bool = False) -> dict:
    """Evaluate every cell of a grid given as flat columns: ``cols`` maps
    n_nodes, r_f, u0_s, w_cp_s, q_s, dt_cp_s (f32, one entry a cell) and
    seeds, cell_index (the Philox key's uint32 words, as int32 tensors of
    the same bits) to tensors; ``cluster_rate`` (f32, the first cells' cluster nodes x r_f)
    gives ``mttf_hours``. Returns f32 ettr, n_failures, dt_s (a cell each)
    and mttf_hours (one per cluster_rate) and, with ``include_mc``, f64
    mc_ettr_mean, mc_ettr_std and mc_n_failures over ``n_runs`` runs a cell
    (queue draws only with ``has_queue``); ``runs`` adds every run's
    run_ettr (f32) and run_fails (int32), shape (cells, n_runs)."""
    global launches
    _check(cols, cluster_rate, include_mc, n_runs)
    dev = cols["n_nodes"].device
    if dev.type == "cpu":
        return stat_grid_ref(cols, cluster_rate, runtime_s=runtime_s, include_mc=include_mc,
                             n_runs=n_runs, has_queue=has_queue, runs=runs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    C, M = cols["n_nodes"].numel(), cluster_rate.numel()
    f32 = [cols[k].contiguous() for k in COLUMNS]
    keys = [cols[k].contiguous() for k in KEYS]
    rate = cluster_rate.contiguous()
    out = {k: torch.empty(C, dtype=torch.float32, device=dev) for k in OUTPUTS[:3]}
    out["mttf_hours"] = torch.empty(M, dtype=torch.float32, device=dev)
    if include_mc:
        out.update({k: torch.empty(C, dtype=torch.float64, device=dev) for k in MC_OUTPUTS})
        if runs:
            out["run_ettr"] = torch.empty((C, n_runs), dtype=torch.float32, device=dev)
            out["run_fails"] = torch.empty((C, n_runs), dtype=torch.int32, device=dev)
    ptr = lambda k: out[k].data_ptr() if k in out else None  # noqa: E731
    lib = _build.load()
    # the Monte-Carlo's scratch: work estimates, the cells' order, chunk sums
    nbytes = lib.stat_grid_scratch_bytes(C, n_runs) if include_mc else 0
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.stat_grid(
            *(t.data_ptr() for t in f32), *(t.data_ptr() for t in keys), rate.data_ptr(),
            C, M, ctypes.c_float(runtime_s), n_runs if include_mc else 0, int(include_mc),
            int(has_queue), *(ptr(k) for k in OUTPUTS), *(ptr(k) for k in MC_OUTPUTS),
            ptr("run_ettr"), ptr("run_fails"), scratch.data_ptr(), nbytes, stream)
    _build.check(lib, err, "stat_grid launch")
    launches += 1
    return out


def philox(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of int64 counter words ``ctr`` (n, 4) under key words
    ``key`` (n, 2), values in [0, 2^32): the output words (n, 4), int64. On
    the card it runs ``csrc/stat_grid.cu``'s generator (for the
    known-answer checks); on the CPU ``philox4x32_10``."""
    global philox_launches
    if ctr.dim() != 2 or ctr.shape[1] != 4 or key.shape != (ctr.shape[0], 2):
        raise ValueError(f"ctr must be (n, 4) and key (n, 2); got {tuple(ctr.shape)}, "
                         f"{tuple(key.shape)}")
    if ctr.device.type == "cpu":
        return torch.stack(philox4x32_10(ctr.unbind(1), key.unbind(1)), 1)
    if ctr.device.type != "cuda":
        raise ValueError(f"unsupported device {ctr.device}")
    c32, k32 = _u32(ctr.reshape(-1)), _u32(key.reshape(-1))
    out = torch.empty_like(c32)
    lib = _build.load()
    with torch.cuda.device(ctr.device):
        stream = torch.cuda.current_stream(ctr.device).cuda_stream
        err = lib.stat_philox(c32.data_ptr(), k32.data_ptr(), out.data_ptr(), ctr.shape[0], stream)
    _build.check(lib, err, "stat_philox launch")
    philox_launches += 1
    return (out.to(torch.int64) & MASK32).view(-1, 4)


def exponential_draws(x: torch.Tensor) -> torch.Tensor:
    """The exponential draw (f32) of each Philox word of ``x`` (int64, values
    in [0, 2^32)). On the card it runs ``csrc/stat_grid.cu``'s own (for the
    check that it equals ``exponential`` at every u); on the CPU
    ``exponential``."""
    global exponential_launches
    if x.device.type == "cpu":
        return exponential(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x32 = _u32(x.reshape(-1))
    out = torch.empty(x32.shape, dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stat_exponential(x32.data_ptr(), out.data_ptr(), x32.numel(), stream)
    _build.check(lib, err, "stat_exponential launch")
    exponential_launches += 1
    return out.view(x.shape)
