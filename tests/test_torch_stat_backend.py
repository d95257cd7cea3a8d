"""The port's statistical layer (``repro_torch.core``: backend, ettr_model,
mttf_model, montecarlo, and the grid kernel's plain version
``repro_torch.kernels.stat_grid``) against the JAX package's.

The reference runs through its ``JAX_VMAP`` and ``NUMPY`` tiers, the port
through ``TORCH`` with ``device="cpu"`` (the kernel's plain version) and
through its ``NUMPY``. Tolerances are the reference's own
(tests/test_backend_parity.py, docs/stat_backend.md): the closed form
5e-4 relative and 5e-5 absolute (E[failures] 1e-3), ``fit_r_f`` 1e-6,
Monte-Carlo means within 0.03 ETTR and 0.5 failures for one cell (0.02 for
free checkpoints), 0.06 and 1.0 over a grid, and ``r_f = 0``, where the
Monte-Carlo is deterministic, 1e-5. The Monte-Carlo tiers draw from other
streams, so they agree in distribution only; the port's NUMPY tier is the
reference's, bit for bit.
"""
import dataclasses
import math
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.core import backend as rbk
from repro.core import ettr_model as rettr
from repro.core import montecarlo as rmc
from repro.core import mttf_model as rmttf
from repro.core.metrics import JobRecord as RJobRecord, JobState as RJobState
from repro_torch.core import backend as tbk
from repro_torch.core import ettr_model as tettr
from repro_torch.core import montecarlo as tmc
from repro_torch.core import mttf_model as tmttf
from repro_torch.core.metrics import JobRecord, JobState
from repro_torch.kernels import stat_grid as sg
from tests.conftest import run_subprocess_py

TORCH, NP = tbk.StatBackend.TORCH, tbk.StatBackend.NUMPY
R_JX, R_NP = rbk.StatBackend.JAX_VMAP, rbk.StatBackend.NUMPY
CPU = "cpu"
NO_CUDA = {"CUDA_VISIBLE_DEVICES": ""}

# Random123's known-answer vectors for Philox4x32-10: (counter, key, output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]

POLICIES = (("hourly", {}), ("daly", dict(dt_cp_s=0.0)),
            ("fast-cp", dict(dt_cp_s=0.0, w_cp_s=30.0)), ("queued", dict(q_s=1800.0)))


def _grids(**kw):
    """The same grid for the port (first) and the reference."""
    pols = kw.pop("policies", (("hourly", {}),))
    return (tbk.BandGrid(policies=tuple(tbk.PolicyCell(n, **p) for n, p in pols), **kw),
            rbk.BandGrid(policies=tuple(rbk.PolicyCell(n, **p) for n, p in pols), **kw))


def _params(**kw):
    return tettr.ETTRParams(**kw), rettr.ETTRParams(**kw)


# -- dispatch seam ----------------------------------------------------------
def test_backend_registry_and_resolution():
    assert set(tbk.BACKEND_MAPPING) == {"numpy", "torch"}
    assert tbk.resolve_backend("numpy") is NP
    assert tbk.resolve_backend(" Torch ") is TORCH      # normalized
    assert tbk.resolve_backend(TORCH) is TORCH
    assert tbk.resolve_backend(None) is tbk.get_backend()
    with pytest.raises(ValueError, match="torch"):
        tbk.resolve_backend("jax_vmap")
    with pytest.raises(TypeError):
        tbk.resolve_backend(3.14)


def test_use_backend_scoped_override():
    prev = tbk.get_backend()
    with tbk.use_backend("torch") as bk:
        assert bk is TORCH
        assert tbk.get_backend() is TORCH
        p, _ = _params(n_nodes=64)
        # the scoped default routes the public estimators; device as asked
        assert tettr.expected_ettr(p, device=CPU) == pytest.approx(
            tettr.expected_ettr(p, backend=NP), rel=5e-4)
    assert tbk.get_backend() is prev


def test_env_var_selects_default_backend():
    code = ("from repro_torch.core.backend import get_backend, StatBackend; "
            "assert get_backend() is StatBackend.TORCH")
    r = run_subprocess_py(code, env_extra={"REPRO_TORCH_STAT_BACKEND": "torch"})
    assert r.returncode == 0, r.stdout + r.stderr
    # the reference's variable is not read: it may name jax_vmap, which the
    # port does not have
    code = ("from repro_torch.core.backend import get_backend, StatBackend; "
            "assert get_backend() is StatBackend.NUMPY")
    r = run_subprocess_py(code, env_extra={"REPRO_STAT_BACKEND": "jax_vmap"})
    assert r.returncode == 0, r.stdout + r.stderr
    code_bad = ("from repro_torch.core.backend import get_backend\n"
                "try:\n    get_backend()\n"
                "except ValueError:\n    raise SystemExit(0)\n"
                "raise SystemExit(1)")
    r = run_subprocess_py(code_bad, env_extra={"REPRO_TORCH_STAT_BACKEND": "cuda"})
    assert r.returncode == 0, r.stdout + r.stderr


def test_torch_tier_without_a_card_raises():
    """With no card and no device="cpu", every TORCH entry raises; it never
    carries on on the CPU."""
    code = (
        "from repro_torch.core import backend as b, ettr_model as e, montecarlo as m, "
        "mttf_model as t\n"
        "p = e.ETTRParams(n_nodes=64)\n"
        "calls = [lambda: b.batch_bands(b.BandGrid(gpus=(1024,), seeds=(0,)), backend='torch'),\n"
        "         lambda: e.expected_ettr(p, backend='torch'),\n"
        "         lambda: e.expected_n_failures(p, backend='torch'),\n"
        "         lambda: e.ettr_contour(backend='torch'),\n"
        "         lambda: m.simulate_run_ettr(p, n_runs=8, backend='torch'),\n"
        "         lambda: t.projected_mttf_hours(1024, 6.5e-3, backend='torch'),\n"
        "         lambda: t.fit_r_f([], backend='torch')]\n"
        "for f in calls:\n"
        "    try:\n"
        "        f()\n"
        "    except RuntimeError as err:\n"
        "        assert 'no CUDA device' in str(err), err\n"
        "    else:\n"
        "        raise SystemExit('ran without a card')\n"
        "print('all raised')\n")
    r = run_subprocess_py(code, env_extra=NO_CUDA)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "all raised" in r.stdout


# -- closed-form parity (randomized over the supported envelope) -----------
@given(n_nodes=st.integers(1, 512), r_f=st.floats(0.0, 1e-2),
       w_cp=st.floats(0.0, 600.0), u0=st.floats(0.0, 900.0),
       q=st.floats(0.0, 3600.0), dt=st.sampled_from([0.0, 1800.0, 3600.0]))
def test_analytic_ettr_parity(n_nodes, r_f, w_cp, u0, q, dt):
    """expected_ettr / expected_n_failures of the port's TORCH tier agree
    with the reference's NUMPY and JAX_VMAP tiers, and the port's NUMPY
    tier equals the reference's, over a randomized grid with the edges
    (w_cp_s = 0 free checkpoints, r_f = 0 no failures)."""
    tp, rp = _params(n_nodes=n_nodes, r_f=r_f, u0_s=u0, w_cp_s=w_cp, q_s=q, dt_cp_s=dt)
    e_np = rettr.expected_ettr(rp, backend=R_NP)
    assert tettr.expected_ettr(tp, backend=NP) == e_np
    e_t = tettr.expected_ettr(tp, backend=TORCH, device=CPU)
    assert e_t == pytest.approx(e_np, rel=5e-4, abs=5e-5)
    assert e_t == pytest.approx(rettr.expected_ettr(rp, backend=R_JX), rel=5e-4, abs=5e-5)
    f_np = rettr.expected_n_failures(rp, backend=R_NP)
    assert tettr.expected_n_failures(tp, backend=NP) == f_np
    f_t = tettr.expected_n_failures(tp, backend=TORCH, device=CPU)
    f_jx = rettr.expected_n_failures(rp, backend=R_JX)
    if math.isinf(f_np):
        assert math.isinf(f_t) and math.isinf(f_jx)
    else:
        assert f_t == pytest.approx(f_np, rel=1e-3, abs=1e-3)
        assert f_t == pytest.approx(f_jx, rel=1e-3, abs=1e-3)


@given(n_gpus=st.integers(8, 131072), r_f=st.floats(1e-4, 2e-2))
def test_mttf_parity(n_gpus, r_f):
    m_np = rmttf.projected_mttf_hours(n_gpus, r_f, backend=R_NP)
    assert tmttf.projected_mttf_hours(n_gpus, r_f, backend=NP) == m_np
    m_t = tmttf.projected_mttf_hours(n_gpus, r_f, backend=TORCH, device=CPU)
    assert m_t == pytest.approx(m_np, rel=5e-4)
    assert m_t == pytest.approx(rmttf.projected_mttf_hours(n_gpus, r_f, backend=R_JX),
                                rel=5e-4)


def test_contour_parity():
    """Figure 10 contour: one grid call matches the numpy double loop and
    the reference's vmapped call over the default 41x41 grid."""
    r_np, w_np, E_np, DT_np = rettr.ettr_contour(backend=R_NP)
    r_jx, w_jx, E_jx, DT_jx = rettr.ettr_contour(backend=R_JX)
    r_t, w_t, E_t, DT_t = tettr.ettr_contour(backend=TORCH, device=CPU)
    np.testing.assert_array_equal(r_t, r_np)
    np.testing.assert_array_equal(w_t, w_np)
    np.testing.assert_allclose(E_t, E_np, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(DT_t, DT_np, rtol=5e-4)
    np.testing.assert_allclose(E_t, E_jx, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(DT_t, DT_jx, rtol=5e-4)
    *_, E_p, DT_p = tettr.ettr_contour(backend=NP)
    np.testing.assert_array_equal(E_p, E_np)
    np.testing.assert_array_equal(DT_p, DT_np)


def _job_logs():
    """One synthetic job log for each package, with a size mix straddling
    min_gpus."""
    rng = np.random.default_rng(11)
    states = ["COMPLETED", "NODE_FAIL", "FAILED", "CANCELLED"]
    t_jobs, r_jobs = [], []
    for i in range(300):
        start = float(rng.uniform(0, 1e5))
        kw = dict(job_id=i, run_id=i, n_gpus=int(rng.choice([8, 64, 256, 1024])),
                  submit_t=start, start_t=start, end_t=start + float(rng.uniform(600, 2e5)))
        state, hw = states[int(rng.integers(len(states)))], bool(rng.integers(2))
        t_jobs.append(JobRecord(state=JobState(state), hw_attributed=hw, **kw))
        r_jobs.append(RJobRecord(state=RJobState(state), hw_attributed=hw, **kw))
    return t_jobs, r_jobs


def test_fit_r_f_parity():
    """The masked-sum torch fit matches the numpy loops of both packages
    and the reference's jax fit, and agrees the log is empty when it is."""
    t_jobs, r_jobs = _job_logs()
    r_np = rmttf.fit_r_f(r_jobs, backend=R_NP)
    assert math.isfinite(r_np) and r_np > 0
    assert tmttf.fit_r_f(t_jobs, backend=NP) == r_np
    r_t = tmttf.fit_r_f(t_jobs, backend=TORCH, device=CPU)
    assert r_t == pytest.approx(r_np, rel=1e-6)
    assert r_t == pytest.approx(rmttf.fit_r_f(r_jobs, backend=R_JX), rel=1e-6)
    assert math.isnan(tmttf.fit_r_f([], backend=NP))
    assert math.isnan(tmttf.fit_r_f([], backend=TORCH, device=CPU))


def test_mttf_curve_and_tables_match_reference():
    """The jax-free rest of the layer, copied: empirical MTTF curve with its
    Gamma CIs, projection table, Eq. 2, and the w_cp bisection."""
    t_jobs, r_jobs = _job_logs()
    curve = [dataclasses.astuple(p) for p in tmttf.empirical_mttf_curve(t_jobs)]
    assert curve and curve == [dataclasses.astuple(p)
                               for p in rmttf.empirical_mttf_curve(r_jobs)]
    assert tmttf.projection_table(6.5e-3) == rmttf.projection_table(6.5e-3)
    for kw in (dict(n_nodes=1536), dict(n_nodes=64, w_cp_s=0.0), dict(n_nodes=8, r_f=0.0)):
        tp, rp = _params(**kw)
        assert tettr.expected_ettr_simple(tp) == rettr.expected_ettr_simple(rp)
    for target in (0.5, 0.9, 0.99):
        a = tettr.required_w_cp_for_target(12288, target)
        b = rettr.required_w_cp_for_target(12288, target)
        assert a == b or (math.isnan(a) and math.isnan(b))


# -- Monte-Carlo ------------------------------------------------------------
@pytest.mark.parametrize("kw,seed", [
    (dict(n_nodes=64, r_f=6.5e-3, dt_cp_s=3600.0), 3),
    (dict(n_nodes=64, r_f=6.5e-3, w_cp_s=0.0, dt_cp_s=0.0), 5),
    (dict(n_nodes=256, r_f=9e-3, q_s=1800.0), 7),
    (dict(n_nodes=64, r_f=0.0, dt_cp_s=3600.0), 0),
])
def test_numpy_montecarlo_matches_reference_bitwise(kw, seed):
    tp, rp = _params(**kw)
    a = tmc.simulate_run_ettr(tp, n_runs=300, seed=seed, backend=NP)
    b = rmc.simulate_run_ettr(rp, n_runs=300, seed=seed, backend=R_NP)
    assert (a.ettr_mean, a.ettr_std, a.n_failures_mean, a.n_runs) == (
        b.ettr_mean, b.ettr_std, b.n_failures_mean, b.n_runs)


def test_mc_parity_nominal():
    tp, rp = _params(n_nodes=64, r_f=6.5e-3, dt_cp_s=3600.0)
    r_np = rmc.simulate_run_ettr(rp, n_runs=1000, seed=3, backend=R_NP)
    r_jx = rmc.simulate_run_ettr(rp, n_runs=1000, seed=3, backend=R_JX)
    r_t = tmc.simulate_run_ettr(tp, n_runs=1000, seed=3, backend=TORCH, device=CPU)
    for ref in (r_np, r_jx):
        assert abs(r_t.ettr_mean - ref.ettr_mean) < 0.03
        assert abs(r_t.n_failures_mean - ref.n_failures_mean) < 0.5


def test_mc_parity_free_checkpoints():
    """w_cp_s = 0 drives the Daly-Young interval to 0 (continuous free
    checkpoints): the kernel's dt_safe guard and free_cp branch."""
    tp, rp = _params(n_nodes=64, r_f=6.5e-3, w_cp_s=0.0, dt_cp_s=0.0)
    r_np = rmc.simulate_run_ettr(rp, n_runs=1000, seed=5, backend=R_NP)
    r_jx = rmc.simulate_run_ettr(rp, n_runs=1000, seed=5, backend=R_JX)
    r_t = tmc.simulate_run_ettr(tp, n_runs=1000, seed=5, backend=TORCH, device=CPU)
    assert r_t.ettr_mean > 0.97          # near-lossless by construction
    assert abs(r_t.ettr_mean - r_np.ettr_mean) < 0.02
    assert abs(r_t.ettr_mean - r_jx.ettr_mean) < 0.02


def test_mc_parity_r_f_zero_is_deterministic():
    """r_f = 0: no failures ever, so the MC collapses to one value every
    tier must hit within float32."""
    tp, rp = _params(n_nodes=64, r_f=0.0, dt_cp_s=3600.0)
    r_np = rmc.simulate_run_ettr(rp, n_runs=200, seed=0, backend=R_NP)
    r_jx = rmc.simulate_run_ettr(rp, n_runs=200, seed=0, backend=R_JX)
    r_t = tmc.simulate_run_ettr(tp, n_runs=200, seed=0, backend=TORCH, device=CPU)
    assert r_t.n_failures_mean == 0.0 == r_np.n_failures_mean
    assert r_t.ettr_mean == pytest.approx(r_np.ettr_mean, rel=1e-5)
    assert r_t.ettr_mean == pytest.approx(r_jx.ettr_mean, rel=1e-5)
    assert r_t.ettr_std == pytest.approx(0.0, abs=1e-6)


def test_philox_known_answers():
    ctr = torch.tensor([k[0] for k in PHILOX_KAT])
    key = torch.tensor([k[1] for k in PHILOX_KAT])
    want = [list(k[2]) for k in PHILOX_KAT]
    assert sg.philox(ctr, key).tolist() == want
    words = sg.philox4x32_10(ctr.unbind(1), key.unbind(1))
    assert torch.stack(words, 1).tolist() == want


def _walk(key, run, lam_s, dt, w, u0, q_s, R_target, has_queue):
    """One run of the attempt process written as the kernel's scalar loop:
    numpy f32 scalars, one rounding an operation, Philox from Python ints."""
    f = np.float32

    def draw(ctr, purpose, word):
        """Word ``word`` of the Philox at counter (ctr, purpose): four draws a
        call, as csrc/stat_grid.cu takes them."""
        x = int(sg.philox4x32_10((*ctr, purpose, 0), key)[word])
        return f(-math.log(((x >> 8) + 1) * 2.0 ** -24))

    free_cp = dt <= 0
    dt_safe = f(1.0) if free_cp else dt
    prod = unprod = queue = f(0.0)
    fails = 0
    if has_queue:
        queue = draw((run // 4, 0), sg.QUEUE0, run % 4) * q_s
    attempt = 0
    while True:
        R_rem = R_target - prod
        m = f(0.0) if free_cp else max(f(np.ceil(R_rem / dt_safe)) - f(1.0), f(0.0))
        t_done = (u0 + R_rem) + m * w
        ttf = (draw((run, attempt // 4), sg.TTF, attempt % 4) / max(lam_s, f(1e-30))
               if lam_s > 0 else f(np.inf))
        if ttf > t_done:
            prod, unprod = R_target, unprod + (u0 + m * w)
            break
        if free_cp:
            prog = min(max(ttf - u0, f(0.0)), R_rem)
        else:
            prog = min(max(f(np.floor((ttf - u0) / (dt_safe + w))), f(0.0)), m) * dt_safe
        prod, unprod = prod + prog, unprod + (max(ttf, u0) - prog)
        if has_queue:
            queue = queue + draw((run, attempt // 4), sg.QUEUE, attempt % 4) * q_s
        fails += 1
        attempt += 1
    return prod / ((prod + unprod) + queue), fails


def _cols(grid):
    cols, rate, _ = tbk.grid_columns(grid, CPU)
    return cols, rate


def test_plain_runs_equal_a_scalar_walk():
    """Every run of the plain version equals, to the bit, the attempt
    process walked one run at a time in numpy f32 (the kernel's loop):
    with and without a queue, free checkpoints, r_f = 0."""
    grid, _ = _grids(gpus=(1024, 8192), seeds=(0, 1), policies=POLICIES + (
        ("free", dict(dt_cp_s=0.0, w_cp_s=0.0)),), r_f=np.array([[6e-3, 0.0], [9e-3, 4e-3]]))
    cols, rate = _cols(grid)
    out = sg.stat_grid(cols, rate, runtime_s=float(np.float32(grid.runtime_s)),
                       include_mc=True, n_runs=12, has_queue=True, runs=True)
    f = np.float32
    for c in range(grid.n_cells):
        lam_s = f(f(cols["n_nodes"][c].item()) * f(cols["r_f"][c].item())) / f(86400.0)
        args = (int(cols["seeds"][c]) & sg.MASK32, int(cols["cell_index"][c]))
        for r in range(12):
            e, n = _walk(args, r, lam_s, f(out["dt_s"][c].item()), f(cols["w_cp_s"][c].item()),
                         f(cols["u0_s"][c].item()), f(cols["q_s"][c].item()),
                         f(grid.runtime_s), True)
            assert (out["run_ettr"][c, r].item(), out["run_fails"][c, r].item()) == (float(e), n)


def test_plain_draws_do_not_depend_on_batching():
    """A cell's runs are the same bits whether its grid has one cell or
    many, and whether it has 16 runs or the first 16 of 40."""
    grid, _ = _grids(gpus=(2048, 16384), seeds=(3, 4, 5), policies=POLICIES)
    cols, rate = _cols(grid)
    kw = dict(runtime_s=float(np.float32(grid.runtime_s)), include_mc=True, has_queue=True,
              runs=True)
    whole = sg.stat_grid(cols, rate, n_runs=40, **kw)
    for c in (0, 7, grid.n_cells - 1):
        one = sg.stat_grid({k: v[c:c + 1] for k, v in cols.items()}, rate[:0], n_runs=16, **kw)
        assert torch.equal(one["run_ettr"][0], whole["run_ettr"][c, :16])
        assert torch.equal(one["run_fails"][0], whole["run_fails"][c, :16])
        assert torch.equal(one["ettr"][0], whole["ettr"][c])


def test_draws_take_all_four_philox_words():
    """Attempt a's draw is word a % 4 of the Philox at counter (run, a // 4,
    purpose); a run's initial queue draw word run % 4 at (run // 4, 0,
    QUEUE0): the plain version's draw functions, against Philox4x32-10
    called word by word."""
    k0, k1 = torch.tensor([7]), torch.tensor([11])
    run = torch.arange(9)
    for attempt in range(9):
        for purpose in (sg.TTF, sg.QUEUE):
            got = sg.exp_draw(k0, k1, run, attempt, purpose)
            words = sg.philox4x32_10((run, attempt // 4, purpose, 0), (k0, k1))
            assert torch.equal(got, sg.exponential(words[attempt % 4]))
    words = torch.stack(sg.philox4x32_10((run // 4, 0, sg.QUEUE0, 0), (k0, k1)))
    want = sg.exponential(words[run % 4, torch.arange(9)])
    assert torch.equal(sg.first_queue_draw(k0, k1, run), want)
    assert torch.equal(sg.exponential_draws(torch.tensor([0, 255, 2 ** 32 - 1])),
                       sg.exponential(torch.tensor([0, 255, 2 ** 32 - 1])))


def test_stat_work_counts_the_draw_scheme():
    """chip_smoke.stat_work's counts for the Monte-Carlo's bound, against
    the draws the scheme makes run by run: a Philox a group of four
    time-to-failure draws, one a group of four failures' queue draws and
    one a group of four runs' initial queue draws where q_s is not 0."""
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    fails = torch.tensor([[0, 3, 4, 7, 8], [1, 0, 2, 5, 11]], dtype=torch.int32)
    q_s = torch.tensor([0.0, 900.0])
    work = cs.stat_work(fails, q_s, True)
    attempts = philox = draws = 0
    for c in range(2):
        for r in range(5):
            f = int(fails[c, r])
            attempts += f + 1
            philox += -(-(f + 1) // 4)
            draws += f + 1
            if q_s[c]:
                philox += -(-f // 4)
                draws += f + 1  # the failures' queue draws and the initial one
        philox += -(-5 // 4) if q_s[c] else 0
    assert (work["attempts"], work["philox"], work["draws"]) == (attempts, philox, draws)
    none = cs.stat_work(fails, q_s, False)
    assert none["draws"] == none["attempts"] == attempts
    ops = work["ops"]
    assert ops["int32"] == philox * cs.STAT_PHILOX_INT + draws * cs.STAT_DRAW_INT
    assert ops["issue"] == ops["int32"] + ops["fp64"] + ops["fp32"] + ops["convert"]
    ms, by = cs.stat_bound_ms(2, 2, work)
    terms = cs.stat_bound_terms(2, 2, work)
    assert ms == max(terms.values()) and by == "operations"


def test_plain_stats_are_the_runs_moments():
    grid, _ = _grids(gpus=(4096,), seeds=(0, 1), policies=POLICIES)
    cols, rate = _cols(grid)
    out = sg.stat_grid(cols, rate, runtime_s=float(np.float32(grid.runtime_s)),
                       include_mc=True, n_runs=64, has_queue=True, runs=True)
    x = out["run_ettr"].double()
    torch.testing.assert_close(out["mc_ettr_mean"], x.mean(1), rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(out["mc_ettr_std"], x.std(1, unbiased=False), rtol=1e-9,
                               atol=1e-15)
    assert torch.equal(out["mc_n_failures"], out["run_fails"].double().mean(1))


# -- batched band grids -----------------------------------------------------
def test_degenerate_one_cell_grid():
    """A single-seed, single-scale, single-policy grid is a valid batch:
    bands have n=1, std=0, and the torch tier makes one call."""
    grid, _ = _grids(gpus=(1024,), seeds=(7,))
    assert grid.shape == (1, 1, 1)
    for bk, dev in ((NP, None), (TORCH, CPU)):
        res = tbk.batch_bands(grid, backend=bk, include_mc=True, device=dev)
        bands = res.bands(0, 0)
        assert bands["ettr"].n == 1
        assert bands["ettr"].std == 0.0
        assert 0.0 < bands["ettr"].mean <= 1.0
        assert math.isfinite(bands["mttf_hours"].mean)
        assert "mc_ettr" in bands
        if bk is TORCH:
            assert res.n_compiled_calls == 1


def _close(res_t, res_r):
    np.testing.assert_allclose(res_t.ettr, res_r.ettr, rtol=5e-4, atol=5e-5)
    fin = np.isfinite(res_r.n_failures)
    np.testing.assert_array_equal(np.isfinite(res_t.n_failures), fin)
    np.testing.assert_allclose(res_t.n_failures[fin], res_r.n_failures[fin], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(res_t.mttf_hours, res_r.mttf_hours, rtol=5e-4)
    np.testing.assert_allclose(res_t.dt_s, res_r.dt_s, rtol=5e-4)


def test_batch_grid_parity_randomized():
    """Full-grid parity on a randomized policy x scale x seed grid with a
    per-cell r_f matrix: the port's TORCH tier against both reference
    tiers, and the port's NUMPY tier equal to the reference's."""
    rng = np.random.default_rng(2)
    seeds, gpus = tuple(range(8)), (512, 2048)
    tg, rg = _grids(gpus=gpus, seeds=seeds, policies=(
        ("hourly", {}), ("daly", dict(dt_cp_s=0.0)), ("queued", dict(q_s=1800.0))),
        r_f=rng.uniform(2e-3, 1.2e-2, size=(len(gpus), len(seeds))))
    res_t = tbk.batch_bands(tg, backend=TORCH, device=CPU)
    assert res_t.n_compiled_calls == 1
    res_np = rbk.batch_bands(rg, backend=R_NP)
    _close(res_t, res_np)
    _close(res_t, rbk.batch_bands(rg, backend=R_JX))
    res_p = tbk.batch_bands(tg, backend=NP)
    for k in ("ettr", "n_failures", "mttf_hours", "dt_s"):
        np.testing.assert_array_equal(getattr(res_p, k), getattr(res_np, k))
    assert res_p.n_compiled_calls == res_np.n_compiled_calls
    assert res_p.table() == res_np.table()


def test_batch_grid_single_seed_parity():
    """Single-seed batches (K=1) exercise the degenerate band-axis
    reshapes on both tiers."""
    tg, rg = _grids(gpus=(1024, 4096), seeds=(42,))
    res_t = tbk.batch_bands(tg, backend=TORCH, device=CPU)
    res_np = rbk.batch_bands(rg, backend=R_NP)
    assert res_t.ettr.shape == res_np.ettr.shape == (1, 2, 1)
    np.testing.assert_allclose(res_t.ettr, res_np.ettr, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(res_t.ettr, rbk.batch_bands(rg, backend=R_JX).ettr,
                               rtol=5e-4, atol=5e-5)


def test_batch_mc_statistical_consistency():
    """include_mc=True: per-cell MC means from the tiers' distinct streams
    stay within sampling noise of each other; the port's NUMPY tier is the
    reference's to the bit."""
    seeds = tuple(range(6))
    kw = dict(gpus=(1024, 4096), seeds=seeds, r_f=np.linspace(5e-3, 8e-3, len(seeds)),
              n_runs=256)
    tg, rg = _grids(**kw)
    res_t = tbk.batch_bands(tg, backend=TORCH, include_mc=True, device=CPU)
    assert res_t.n_compiled_calls == 1
    for ref in (rbk.batch_bands(rg, backend=R_NP, include_mc=True),
                rbk.batch_bands(rg, backend=R_JX, include_mc=True)):
        assert np.max(np.abs(res_t.mc_ettr_mean - ref.mc_ettr_mean)) < 0.06
        assert np.max(np.abs(res_t.mc_n_failures - ref.mc_n_failures)) < 1.0
    res_p = tbk.batch_bands(tg, backend=NP, include_mc=True)
    ref = rbk.batch_bands(rg, backend=R_NP, include_mc=True)
    for k in ("mc_ettr_mean", "mc_ettr_std", "mc_n_failures"):
        np.testing.assert_array_equal(getattr(res_p, k), getattr(ref, k))


def test_band_contains_pads():
    b = tbk.Band("x", n=3, mean=0.5, std=0.1, p5=0.4, p50=0.5, p95=0.6, lo=0.4, hi=0.6)
    assert b.contains(0.5)
    assert not b.contains(0.35)
    assert b.contains(0.35, pad_lo=0.1)
    assert not b.contains(float("nan"))
