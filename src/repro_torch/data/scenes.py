"""Serving cameras: the default viewpoint and the canonical orbit."""
from __future__ import annotations

import math

from repro_torch.core import render


def default_camera(height=256, width=256) -> render.Camera:
    return render.Camera(
        height=height, width=width, focal=0.9 * width,
        c2w=render.look_at((2.2, 1.6, 1.8), (0.0, 0.0, 0.0)))


def orbit_camera(height: int, width: int, angle: float) -> render.Camera:
    """Viewpoint on the canonical serving orbit (radius 2.2, z=1.6,
    looking at the origin)."""
    eye = (2.2 * math.cos(angle), 2.2 * math.sin(angle), 1.6)
    return render.Camera(height=height, width=width, focal=0.9 * width,
                         c2w=render.look_at(eye, (0.0, 0.0, 0.0)))
