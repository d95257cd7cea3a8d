"""Device time of the model's forward and backward a step: CUDA events
around each call of the port's ``models.steps.loss_and_grads`` in the
traced run's window (wrapped from the benchmark), their mean."""
LAYER = "model"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_tokens_per_s"


def read(run):
    return run.span_ms("loss_and_grads")
