"""Device milliseconds a training step in the program's ``backward``
intervals: the gradients (``torch.autograd.grad`` of the loss), their
sum over the traced window's steps over its steps."""
from ngbench import program_spans

LAYER = "train step"
UNIT = "ms"
MOVES = "train_step_ms"
SOURCE = "device_trace"

program_spans.start()


def read(run):
    return program_spans.device_ms_per_unit(run, "backward", run.units)
