"""The whole render step's share of the card's peak: the counted least
time of the FLOPs of every tile of the traced window (products at 495
TFLOP/s, the rest at 67) over the window's wall time."""
from ngbench import readers

LAYER = "render step"
UNIT = "%"
MOVES = "mpix_per_s"
SOURCE = "device_trace"


def read(run):
    return readers.mfu_pct(run)
