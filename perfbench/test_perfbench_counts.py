"""The yardstick's counts against hand counts at a tiny shape, and the
per-layer readers on a made-up traced run."""
import re
import subprocess
import sys

import pytest

from perfbench import cost, devtrace, harness

TINY = dict(name="tiny", family="dense", n_layers=1, layer_kind="global", d_model=8, n_heads=2,
            n_kv_heads=1, d_head=4, d_ff=16, vocab_size=32, window=0, ffn_gated=False,
            tie_embeddings=False, moe=None)


def test_parameter_counts_by_hand():
    # embed 256, lm_head 256, wq 64, wk 32, wv 32, wo 64, w_up 128, w_down 128, 4 norms of 8
    assert cost.param_count(TINY) == 984
    assert cost.active_param_count(TINY) == 984 - 256
    moe = dict(TINY, ffn_gated=True, moe=dict(n_experts=4, top_k=2))
    # the FFN becomes a router (8 x 4) and three expert stacks of 4 x 128
    assert cost.param_count(moe) == 984 - 256 + 32 + 3 * 512
    assert cost.active_param_count(moe) == 984 - 256 - 256 + 32 + 3 * 512 // 2


def test_model_flops_by_hand():
    # 6 x 728 x (2 x 4 tokens) + 12 x B 2 x H 2 x D 4 x 10 causal pairs
    assert cost.model_flops(TINY, 2, 4) == 6 * 728 * 8 + 12 * 2 * 2 * 4 * 10
    local = dict(TINY, layer_kind="local", window=2)
    assert cost.attention_flops(local, 2, 4) == 12 * 2 * 2 * 4 * 7  # pairs 1 + 2 + 2 + 2


def test_flash_work_and_bound_by_hand():
    assert cost.attended_pairs(4, 4, causal=True) == 10
    assert cost.attended_pairs(4, 4, causal=True, window=2) == 7
    fwd = cost.flash_fwd(1, 4, 4, 2, 1, 4, 2, causal=True, with_lse=True)
    assert fwd == (4 * 2 * 4 * 10, (2 * 4 * 2 * 4 + 2 * 4 * 4) * 2 + 2 * 4 * 4)
    bwd = cost.flash_bwd(1, 4, 4, 2, 1, 4, 2, causal=True)
    assert bwd == (10 * 2 * 4 * 10, (4 * 4 * 2 * 4 + 4 * 4 * 4) * 2 + 2 * 4 * 4)
    # tiny shapes are bound by bytes
    want = fwd[1] / cost.HBM_BW * 1e3 + bwd[1] / cost.HBM_BW * 1e3
    assert cost.flash_bound_ms(TINY, 1, 4) == pytest.approx(want, rel=1e-12)


class FakeSpans:
    def __init__(self, ms):
        self._ms = ms

    def ms(self, name):
        return self._ms.get(name, [])


def _run(ops, spans=None):
    events = [{"cat": "kernel", "name": "spin_kernel", "ts": 0.0, "dur": 10.0, "ph": "X"},
              {"cat": "kernel", "name": "spin_kernel", "ts": 1010.0, "dur": 10.0, "ph": "X"}]
    events += [{"cat": "kernel", "name": n, "ts": ts, "dur": dur, "ph": "X"} for n, ts, dur in ops]
    win = devtrace.Window(events)
    traffic = {"batch": 2, "seq_len": 4, "n_microbatches": 1}
    return harness.TracedRun(TINY, traffic, steps=4, wall_s=2.0,
                             spans=FakeSpans(spans or {}), window=win, trace_steps=2,
                             peak=3 * 2**30)


def test_readers_on_a_made_up_run():
    ops = [("void flash_fwd_wgmma_kernel<4>(x)", 10.0, 100.0),
           ("void dkdv_kernel<4>(x)", 100.0, 200.0),    # overlaps the forward by 10
           ("void dq_kernel<4>(x)", 500.0, 100.0),
           ("gemm", 800.0, 100.0)]
    run = _run(ops, {"loss_and_grads": [4.0, 6.0], "apply": [2.0, 2.0]})
    read = {n: harness.metric_module(n).read(run) for n in
            ("step_mfu", "fwd_bwd_ms", "optimizer_ms", "optimizer_hbm_roofline",
             "flash_roofline", "device_idle_share", "peak_mem_gib")}
    assert read["fwd_bwd_ms"] == 5.0 and read["optimizer_ms"] == 2.0
    assert read["peak_mem_gib"] == 3.0
    # window 1000 us, busy 10..300, 500..600, 800..900 = 490
    assert run.trace.window_s == pytest.approx(1e-3) and run.trace.busy_s == pytest.approx(4.9e-4)
    assert read["device_idle_share"] == pytest.approx(51.0)
    flops = 6 * 728 * 8 + 12 * 2 * 2 * 4 * 10
    assert read["step_mfu"] == pytest.approx(flops / 0.5 / 989e12 * 100)
    assert read["optimizer_hbm_roofline"] == pytest.approx(28 * 984 / 3.35e12 * 1e3 / 2.0 * 100)
    bound = cost.flash_bound_ms(TINY, 2, 4) * 1 * 1 * 2
    assert read["flash_roofline"] == pytest.approx(bound / 0.4 * 100)
    assert [n for n, _ in run.trace.idle_gaps()] == ["(no host op)"]


@pytest.mark.parametrize("missing", ["flash_fwd", "dkdv_kernel", "dq_kernel"])
def test_a_trace_without_the_flash_rows_reads_nothing_and_no_zero(missing):
    ops = [(n, 10.0 + 100 * i, 50.0) for i, n in enumerate(
        ["void flash_fwd_wgmma_kernel<4>(x)", "void dkdv_kernel<4>(x)", "void dq_kernel<4>(x)"])
        if not n.split()[1].startswith(missing)]
    assert harness.metric_module("flash_roofline").read(_run(ops)) is None


def test_a_traced_run_without_spans_reads_nothing():
    run = _run([("gemm", 10.0, 10.0)])
    for name in ("fwd_bwd_ms", "optimizer_ms", "optimizer_hbm_roofline"):
        assert harness.metric_module(name).read(run) is None


@pytest.mark.parametrize("missing", ["loss_and_grads", "apply", "dq_kernel"])
def test_a_traced_run_missing_a_span_or_a_flash_row_fails(missing):
    """Where a wrapped function of the port is no longer called, or a flash
    kernel no longer found by its name, the traced run fails: the metric is
    neither 0 nor left out."""
    ops = [(n, 10.0 + 100 * i, 50.0) for i, n in enumerate(
        ["void flash_fwd_wgmma_kernel<4>(x)", "void dkdv_kernel<4>(x)", "void dq_kernel<4>(x)"])
        if missing not in n]
    spans = {k: v for k, v in {"loss_and_grads": [4.0], "apply": [2.0]}.items() if k != missing}
    bench = harness.benchmark()
    cell = bench["workloads"][0]["name"]
    whole = _run(ops + [(f"void {missing}<4>(x)", 700.0, 10.0)],
                 {"loss_and_grads": [4.0], "apply": [2.0]})
    assert len(harness.per_layer(bench, cell, whole)) == len(bench["per_layer"])
    with pytest.raises(harness.MissingReading):
        harness.per_layer(bench, cell, _run(ops, spans))


def test_the_flash_names_match_the_ports_kernels():
    """Every kernel the metric file lists is a ``__global__`` of the port's
    flash sources."""
    import pathlib

    csrc = pathlib.Path(harness.ROOT) / "src" / "repro_torch" / "kernels" / "csrc"
    text = (csrc / "flash_attention.cu").read_text() + (csrc / "flash_attention_bwd.cu").read_text()
    for name in harness.metric_module("flash_roofline").KERNELS:
        assert re.search(r"\b" + name + r"\s*\(", text), name


def test_the_command_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", "train.granite-20b.s2048",
         "--seed", "2147483653", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path),
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
