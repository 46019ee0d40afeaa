"""Device milliseconds a frame of every event that is none of the port's
five kernels (the tile layer's plain ops, copies and fills), from the
traced window: their sum over the window's tiles, times a frame's tiles."""
from ngbench import readers

LAYER = "tile"
UNIT = "ms"
MOVES = "mpix_per_s"
SOURCE = "device_trace"


def read(run):
    return (1e3 * readers.plain_device_s(run) / run.tiles * run.tiles_per_frame) if run.tiles else None
