"""``encode_bwd``'s share of its roofline in the training window: the
points and cotangent in, the whole table gradient out, over its device
time."""
from ngbench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "train_step_ms"
SOURCE = "device_trace"


def read(run):
    return readers.roofline_pct(run, "encode_bwd")
