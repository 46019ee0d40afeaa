"""The share of the traced window, in %, in which the device trace shows
no event while the host is inside the program's enqueue of work: a
``serve.dispatch`` span (``idle_in_enqueue_pct.serve``) or a
``train.step`` span (``idle_in_enqueue_pct.train``). The idle gaps of
the device's events intersected with those host spans, on the clock they
share."""
from ngbench import program_spans

LAYER = "device"
UNIT = "%"
MOVES = {"serve": "mpix_per_s", "train": "train_step_ms"}
SOURCE = "device_trace"

program_spans.start()


def read(run):
    return program_spans.idle_in_pct(run, ("serve.dispatch", "train.step"))
