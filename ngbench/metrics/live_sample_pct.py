"""The share of the window's samples that the occupancy grid left live,
from the engine's on-device ``[live, total, dropped]`` rows
(``RenderEngine.stats()``) over the traced window."""
LAYER = "occupancy"
UNIT = "%"
MOVES = "mpix_per_s"
SOURCE = "program_counter"


def read(run):
    live, total, _ = run.samples
    return 100.0 * live / total if total > 0 else None
