"""Device milliseconds a training step in the program's ``ssm`` phases:
the Mamba-2 mixers of the forward (the backward recomputes them on
autograd's own thread, outside the step's scope, where a phase records no
device interval), their sum over the traced window's steps over its
steps."""
from ngbench import program_lm, program_spans

LAYER = "ssm"
UNIT = "ms"
MOVES = "train_step_ms"
SOURCE = "device_trace"

program_lm.record_phases(("ssm",))


def read(run):
    return program_spans.device_ms_per_unit(run, "ssm", run.units)
