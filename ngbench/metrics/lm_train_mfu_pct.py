"""The whole LM train step's share of the card's BF16 peak: the counted
model FLOPs of every step of the traced window (``lm_counts``: three
times the forward, from the configuration file) at 989.4 TFLOP/s over the
window's wall time."""
from ngbench import readers

LAYER = "train step"
UNIT = "%"
MOVES = "train_step_ms"
SOURCE = "device_trace"


def read(run):
    return readers.mfu_pct(run)
