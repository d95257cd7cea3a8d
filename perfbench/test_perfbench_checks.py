"""The comparison that decides ``correct`` sees a broken timed path: a run
of each cell at a size the CPU holds (the look for a card skipped, the
rest of a run driven as ``run.py`` drives it), sound and then with each
fault a training cell can have planted under the step; and the controls
(the reference in float8, the port's 8-bit AdamW state) fail the cell's
limits where the sound program meets them."""
import time

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.test_perfbench_reference import tiny

CELLS = ("train.granite-20b.s8192", "train.mixtral-8x22b.s4096", "train.granite-20b.s2048")
# The cells' limits hold the full widths' bf16 noise; at the tiny size the
# noise is larger, so the limits here were set by the same rule from the
# tiny size's readings (``calibrate.readings`` on the CPU, seeds 2**31 + 300
# .. 311): above the sound program's largest, below the least of the
# float8 control's (where 3x or more) and the faults' (10x or more; a
# state left unchanged, 3x or more).
DENSE = {"loss_gap": 0.0021, "grad_gap": 0.017, "update_gap": 0.024, "grad_err": 0.053,
         "update_err": 0.48}
TEST_LIMITS = {"train.granite-20b.s8192": DENSE, "train.granite-20b.s2048": DENSE,
               "train.mixtral-8x22b.s4096": {"loss_gap": 0.0087, "grad_gap": 0.0042,
                                             "update_gap": 0.027, "grad_err": 0.051,
                                             "update_err": 0.45, "route_gap": 0.00092}}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name, fault=None):
    cfg, traffic = tiny(name)
    return harness.run_cell(name, 2**31 + 101, 0.05, False, torch.device("cpu"),
                            t_start=time.perf_counter(), cfg=cfg, traffic=traffic,
                            limits=TEST_LIMITS[name], fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", harness.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_under_the_step_makes_the_run_incorrect(name, fault):
    result = _run(name, fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_controls_fail_the_limits(name):
    cfg, traffic = tiny(name)
    rows = calibrate.readings(name, 2**31 + 202, torch.device("cpu"), cfg, traffic)
    limits = TEST_LIMITS[name]
    assert all(rows["sound"][k] <= limit for k, limit in limits.items()), rows["sound"]
    for variant in ("fp8", "opt8bit", "half_batch", "leaf_unmoved"):
        assert any(rows[variant][k] > limit for k, limit in limits.items()), \
            (variant, rows[variant])


def test_each_cell_has_a_limit_for_each_of_its_numbers():
    """The cells' own limits (set from chip runs at the cells' sizes,
    PERF.md) cover the same numbers as the tiny size's."""
    for name in CELLS:
        cell, cfg, _ = harness.cell_files(name)
        assert set(cell["limits"]) == set(TEST_LIMITS[name])
        assert all(0 < v < 1 for v in cell["limits"].values())
