"""Host milliseconds a tile spends in ``RenderEngine.submit``, by the
harness's clock around each call in the traced window: their sum over
their count. It includes the wait ``submit`` makes while more than
``max_inflight`` tiles are queued."""
LAYER = "engine"
UNIT = "ms"
MOVES = "mpix_per_s"
SOURCE = "host_clock"


def read(run):
    return (1e3 * sum(run.submit_s) / len(run.submit_s)) if run.submit_s else None
