"""The traffic generators give the same frames and batches from the same
seed, and other ones from another."""
import itertools

import pytest
import torch

from ngbench import spec


def _positions(here, seed, n=20):
    cell = spec.find_cell("nerf_hash.frames_720p", here)
    gen = spec.generator(cell, here)
    return [list(itertools.islice(v.frames(), n))
            for v in gen.make(cell.traffic, seed)]


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**33 + 5])
def test_viewers_repeat_from_a_seed(tiny, seed):
    a, b = _positions(tiny, seed), _positions(tiny, seed)
    assert a == b
    assert a != _positions(tiny, seed + 1)
    cell = spec.find_cell("nerf_hash.frames_720p", tiny)
    lo, hi = cell.traffic["step_positions"]
    for frames in a:
        steps = [(y - x) % cell.traffic["orbit_positions"]
                 for x, y in zip(frames, frames[1:])]
        assert all(lo <= s <= hi for s in steps)


def test_ray_pool_repeats_from_a_seed(tiny):
    cell = spec.find_cell("nerf_hash.train_32k_rays", tiny)
    gen = spec.generator(cell, tiny)
    cpu = torch.device("cpu")
    a = gen.make(cell.traffic, 2**31 + 3, cpu)
    b = gen.make(cell.traffic, 2**31 + 3, cpu)
    c = gen.make(cell.traffic, 2**31 + 4, cpu)
    assert len(a) == cell.traffic["pool"]
    for x, y in zip(a, b):
        for k in ("origins", "dirs", "target"):
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["dirs"], c[0]["dirs"])
    # rows all differ within a batch and between the first batches
    d = torch.cat([a[i]["dirs"] for i in range(3)])
    assert torch.unique(d, dim=0).shape[0] == d.shape[0]
    assert torch.allclose(a[0]["dirs"].norm(dim=-1), torch.ones(1))
