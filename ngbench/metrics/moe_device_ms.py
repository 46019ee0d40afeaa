"""Device milliseconds a training step in the program's ``moe`` phases:
each expert layer of the forward (router, dispatch, the held experts'
grouped products, combine and shared expert; the backward's recompute
runs on autograd's own thread, outside the step's scope, where a phase
records no device interval), their sum over the traced window's steps
over its steps."""
from ngbench import program_lm, program_spans

LAYER = "moe"
UNIT = "ms"
MOVES = "train_step_ms"
SOURCE = "device_trace"

program_lm.record_phases(("moe",))


def read(run):
    return program_spans.device_ms_per_unit(run, "moe", run.units)
