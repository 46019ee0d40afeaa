"""``field_fwd``'s share of its roofline: the counted least time of its
counted calls over their device time. ``field_roofline_pct.serve``
counts the calls of the checked frames' tiles (their distinct table rows
from the reference's points); ``field_roofline_pct.train`` every step's
call (its distinct rows from its pool batch)."""
from ngbench import readers

LAYER = "kernels"
UNIT = "%"
MOVES = {"serve": "mpix_per_s", "train": "train_step_ms"}
SOURCE = "device_trace"


def read(run):
    return readers.roofline_pct(run, "field_fwd")
