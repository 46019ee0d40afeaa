"""Viewers in a closed loop, each on the serving orbit: the generator of
the serving mixes.

A mix file gives ``viewers``, the frame's ``height`` and ``width``,
``orbit_positions`` (the orbit's camera positions, evenly spaced) and
``step_positions`` ``[lo, hi]``. Viewer ``v`` renders scene ``v`` modulo
the cell's scenes. It starts at a position drawn from the seed and moves
by a whole number of positions in ``[lo, hi]`` each frame, drawn from the
seed. Every seed therefore gives the same frame sizes and the same set of
cameras, visited in another order: the occupancy budget of a culled cell
is checked on every position of the orbit.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List

import numpy as np

from ngbench.scenes import orbit_camera


class Viewer:
    def __init__(self, index: int, params: Dict, seed: int):
        self.index = index
        self.height, self.width = params["height"], params["width"]
        self.positions = params["orbit_positions"]
        self._lo, self._hi = params["step_positions"]
        self._rng = np.random.default_rng([seed, index])
        self.start = int(self._rng.integers(0, self.positions))

    def frames(self) -> Iterator[int]:
        """Orbit positions of the viewer's frames, in order."""
        pos = self.start
        while True:
            yield pos
            pos = (pos + int(self._rng.integers(self._lo, self._hi + 1))) \
                % self.positions

    def camera(self, position: int):
        return camera_at(self.height, self.width, self.positions, position)


def camera_at(height: int, width: int, positions: int, position: int):
    return orbit_camera(height, width, 2.0 * math.pi * position / positions)


def make(params: Dict, seed: int) -> List[Viewer]:
    if params.get("generator") != "viewers":
        raise ValueError(f"not a viewers mix: {params.get('generator')!r}")
    return [Viewer(v, params, seed) for v in range(params["viewers"])]
