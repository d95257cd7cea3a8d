"""The caching allocator's peak over the traced run's window
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""
LAYER = "device"
UNIT = "GiB"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "train_tokens_per_s"


def read(run):
    return run.window_peak_bytes / 2**30
