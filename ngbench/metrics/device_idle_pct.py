"""100 minus the union of device events over the traced window's wall
time: ``device_idle_pct.serve`` in the serving cells,
``device_idle_pct.train`` in the training cells."""
from ngbench import readers

LAYER = "device"
UNIT = "%"
MOVES = {"serve": "mpix_per_s", "train": "train_step_ms"}
SOURCE = "device_trace"


def read(run):
    return readers.idle_pct(run)
