"""The AdamW update's share of its memory bound: 28 bytes a parameter (p,
g, m and v read, p, m and v written, f32) at the card's HBM rate, over
``optimizer_ms``."""
from perfbench import cost

LAYER = "optimizer"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
MOVES = "train_tokens_per_s"


def read(run):
    ms = run.span_ms("apply")
    if ms is None:
        return None
    bound_ms = cost.ADAMW_BYTES_PER_PARAM * cost.param_count(run.cfg) / cost.HBM_BW * 1e3
    return bound_ms / ms * 100.0
