"""The flash kernels' share of their bound: one bf16 forward (with its
LSE) and one backward a layer and microbatch at the cell's shape
(``cost.flash_bound_ms``, the frozen closed forms), over the device time of
the flash kernels' rows in the traced steps.  Under remat ``full`` the
forward runs twice a step, and both runs count in the time.  A trace that
lacks the forward's or the backward's rows reads nothing (the metric is
left out of the line), never 0."""
import re

from perfbench import cost

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"

# the port's flash kernels (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu)
KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel", "delta_kernel", "dkdv_kernel",
           "dq_kernel", "split_sum_kernel")
REQUIRED = (("flash_fwd_wgmma_kernel", "flash_fwd_kernel"), ("dkdv_kernel",), ("dq_kernel",))


def _pattern(names):
    return re.compile(r"\b(" + "|".join(names) + r")\b")


def read(run):
    if any(run.trace.op_seconds(_pattern(group)) <= 0 for group in REQUIRED):
        return None
    t = run.traffic
    micro = t["batch"] // t["n_microbatches"]
    bound_ms = (cost.flash_bound_ms(run.cfg, micro, t["seq_len"]) * run.cfg["n_layers"]
                * t["n_microbatches"] * run.trace_steps)
    return bound_ms / (run.trace.op_seconds(_pattern(KERNELS)) * 1e3) * 100.0
