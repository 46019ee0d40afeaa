"""Device milliseconds a training step in the program's ``forward``
intervals: the loss (the field, the composite and the mean square
error), their sum over the traced window's steps over its steps."""
from ngbench import program_spans

LAYER = "train step"
UNIT = "ms"
MOVES = "train_step_ms"
SOURCE = "device_trace"

program_spans.start()


def read(run):
    return program_spans.device_ms_per_unit(run, "forward", run.units)
