"""Milliseconds a tile waits on the device's queue: from the end of its
``serve.dispatch`` span (the host has enqueued it) to the start of its
``serve.tile`` device interval (the device reaches its first op), 0 where
the device began first; the mean over the traced window's tiles."""
from ngbench import program_spans

LAYER = "engine"
UNIT = "ms"
MOVES = "frame_p95_ms"
SOURCE = "device_trace"

program_spans.start()


def read(run):
    sp = program_spans.spans(run)
    return program_spans.queue_wait_ms(sp) if sp else None
