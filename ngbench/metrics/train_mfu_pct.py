"""The whole train step's share of the card's peak: the counted least time
of the FLOPs of every step of the traced window (forward, backward and
Adam) over the window's wall time."""
from ngbench import readers

LAYER = "train step"
UNIT = "%"
MOVES = "train_step_ms"
SOURCE = "device_trace"


def read(run):
    return readers.mfu_pct(run)
