"""Monte-Carlo validation of the analytical E[ETTR] (paper: 'Comparing to a
Monte Carlo approach ... the approximation above is accurate to within ~5%,
even for large, long-running hypothetical jobs (e.g. 8k GPUs)'); the port
of ``repro.core.montecarlo``."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.ettr_model import ETTRParams, SECONDS_PER_DAY


@dataclass
class MCResult:
    ettr_mean: float
    ettr_std: float
    n_failures_mean: float
    n_runs: int


def simulate_run_ettr(p: ETTRParams, *, n_runs: int = 2000,
                      seed: int = 0, backend=None, device=None) -> MCResult:
    """Simulate job runs with Poisson failures, per-interruption queue +
    restart overheads, periodic checkpoint writes, and measure realized
    ETTR = R / (R + U + Q).

    Vectorized across runs: each loop iteration advances every still-active
    run by one *attempt*, whose outcome has a closed form.  An attempt with
    remaining progress ``R_rem`` pays restart overhead ``u0``, then cycles
    of (produce ``dt``, write checkpoint ``w``); checkpoint ``j`` becomes
    durable at ``u0 + j*(dt + w)``.  Against a failure at ``ttf``:

      * completes iff ``ttf > u0 + R_rem + m*w`` with ``m = ceil(R_rem/dt)-1``
        full checkpoint writes before the final (unwritten) interval;
      * otherwise durable progress is ``j*dt`` with
        ``j = clip(floor((ttf - u0)/(dt + w)), 0, m)`` and everything else
        (restart, writes, work since the last durable checkpoint) counts as
        unproductive time ``max(ttf, u0) - j*dt``.

    ``w_cp_s=0`` drives the Daly-Young interval to 0 (free continuous
    checkpoints): a failed attempt then keeps ``clip(ttf - u0, 0, R_rem)``
    of durable progress instead of a whole number of intervals.

    ``backend=StatBackend.TORCH`` routes to the float32 grid kernel in
    ``repro_torch.core.backend`` (same attempt process, Philox draws keyed
    by (seed, 0); parity with this path is statistical, not bitwise), on
    the card unless ``device="cpu"``.  The numpy path is the reference's,
    bit for bit, and ignores ``device``.
    """
    from repro_torch.core import backend as _bk

    if _bk.resolve_backend(backend) is _bk.StatBackend.TORCH:
        mean, std, nf = _bk.torch_simulate_run_ettr(p, n_runs=n_runs,
                                                    seed=seed, device=device)
        return MCResult(mean, std, nf, n_runs)
    rng = np.random.default_rng(seed)
    lam_s = p.lam / SECONDS_PER_DAY  # failures per wall-second of running
    dt = p.resolved_dt_s()
    w = p.w_cp_s
    u0 = p.u0_s
    R_target = p.runtime_s
    free_cp = dt <= 0.0

    productive = np.zeros(n_runs)
    unproductive = np.zeros(n_runs)
    queue = rng.exponential(p.q_s, n_runs) if p.q_s > 0 \
        else np.zeros(n_runs)
    fails = np.zeros(n_runs)
    active = np.arange(n_runs)
    while active.size:
        R_rem = R_target - productive[active]
        m = np.zeros(active.size) if free_cp \
            else np.maximum(np.ceil(R_rem / dt) - 1.0, 0.0)
        t_done = u0 + R_rem + m * w
        ttf = rng.exponential(1.0 / lam_s, active.size) if lam_s > 0 \
            else np.full(active.size, np.inf)
        done = ttf > t_done
        idx = active[done]
        productive[idx] = R_target
        unproductive[idx] += u0 + m[done] * w
        idx = active[~done]
        tf = ttf[~done]
        if free_cp:
            prog = np.clip(tf - u0, 0.0, R_rem[~done])
        else:
            prog = np.clip(np.floor((tf - u0) / (dt + w)),
                           0.0, m[~done]) * dt
        productive[idx] += prog
        unproductive[idx] += np.maximum(tf, u0) - prog
        fails[idx] += 1
        if p.q_s > 0 and idx.size:
            queue[idx] += rng.exponential(p.q_s, idx.size)
        active = idx
    W = productive + unproductive + queue
    ettrs = productive / W
    return MCResult(float(ettrs.mean()), float(ettrs.std()),
                    float(fails.mean()), n_runs)
