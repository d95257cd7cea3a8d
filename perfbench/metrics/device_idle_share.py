"""The share of the traced steps' device window (marker to marker) in which
no device operation ran: one less the union of the operations' intervals
over the window."""
LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(run):
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100.0
