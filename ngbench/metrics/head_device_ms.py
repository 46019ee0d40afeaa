"""Device milliseconds a frame in the program's ``head`` intervals:
everything nerf's field does after the density field call (``exp``, the
direction encoding, the colour input's ``cat``, the colour MLP, the
``sigmoid`` and the output's ``cat``), their sum over the traced window's
tiles, times a frame's tiles."""
from ngbench import program_spans

LAYER = "tile"
UNIT = "ms"
MOVES = "mpix_per_s"
SOURCE = "device_trace"

program_spans.start()


def read(run):
    ms = program_spans.device_ms_per_unit(run, "head",
                                          getattr(run, "tiles", 0))
    return None if ms is None else ms * run.tiles_per_frame
