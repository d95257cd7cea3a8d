"""The whole training step's share of the card's bf16 peak: the model
FLOPs of a step (``cost.model_flops``: 6 per active parameter and token,
the embedding's gather left out, routed experts at top_k of n_experts, plus
attention's products a layer, no recompute) over the traced run's mean
step wall, host clock from the first timed step's start to the last one's
end."""
from perfbench import cost

LAYER = "steps"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"


def read(run):
    flops = cost.model_flops(run.cfg, run.traffic["batch"], run.traffic["seq_len"])
    return flops / run.step_s / cost.PEAK_FLOPS["bfloat16"] * 100.0
