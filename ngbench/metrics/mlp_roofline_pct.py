"""``mlp_fwd``'s share of its roofline while serving nerf: the counted
least time of every call of the traced window over their device time."""
from ngbench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "mpix_per_s"
SOURCE = "device_trace"


def read(run):
    return readers.roofline_pct(run, "mlp_fwd")
