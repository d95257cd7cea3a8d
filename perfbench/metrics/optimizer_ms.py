"""Device time of the AdamW update a step: CUDA events around each call of
the port's ``optim.adamw.apply`` in the traced run's window (wrapped from
the benchmark), their mean."""
LAYER = "optimizer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_tokens_per_s"


def read(run):
    return run.span_ms("apply")
