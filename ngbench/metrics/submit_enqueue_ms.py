"""Host milliseconds a tile spends in ``RenderEngine.submit`` other than
waiting for older tiles: the harness's clock around each call of the
traced window (``submit_host_ms``'s) less the program's
``serve.backpressure`` spans of the window (the wait for the oldest
ticket while more than ``max_inflight`` tiles are queued), over the
calls."""
from ngbench import program_spans

LAYER = "engine"
UNIT = "ms"
MOVES = "mpix_per_s"
SOURCE = "host_clock"

program_spans.start()


def read(run):
    sp = program_spans.spans(run)
    submit_s = getattr(run, "submit_s", None)
    if not sp or not submit_s:
        return None
    wait_s = sum(e - s for name, _, s, e, _, dev in sp
                 if name == "serve.backpressure" and dev is None) / 1e9
    return 1e3 * (sum(submit_s) - wait_s) / len(submit_s)
