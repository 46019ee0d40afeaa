"""The JAX package's sharded paths on four forced host devices, written to
an ``.npz`` for ``tests/test_torch_sharding.py`` (which runs this as a
subprocess, since the device count is fixed when JAX starts):

    PYTHONPATH=src python -m tests.jax_sharding_reference out.npz

At a small size (nerf and gia, hash grid of 4 levels of 2^10 rows, tiles
of 64 pixels x 8 samples): ``shard_tile_fn`` on a 4-shard mesh, dense on
a partly valid tile and culled with a budget that overflows on some
shards but not all (its ``with_aux`` rows); the sharded engine's frame;
``data_parallel_grad_fn``'s loss and gradients; ``pixel_shard_count`` on
(4, 1), (2, 2) and (1, 4) meshes. The params, the occupancy grid and the
batches go into the file too, so the port reads the same inputs.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common import partitioning  # noqa: E402
from repro.common.param import unbox  # noqa: E402
from repro.core import fields, occupancy, pipeline, train  # noqa: E402
from repro.data import scenes  # noqa: E402
from repro.serve import RenderEngine, sharding  # noqa: E402
from repro.train import loop  # noqa: E402
from tests.conftest import small_field_config  # noqa: E402

LOG2_T, LEVELS = 10, 4
TILE, SAMPLES = 64, 8
# pixels of a 16x16 view, in shard order: shards 0 and 1 look through the
# middle of the volume (24 and 22 live samples), shards 2 and 3 through its
# edges (12 and 11), so a budget of an eighth of the dense count (16 a
# shard) overflows on the first two only
SIDE = 16
BUDGET = TILE * SAMPLES // 8
N_VALID = 40                      # the dense tile: shard 2 in part, 3 not
DP_BATCH = {"nerf": 32, "gia": 256}


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = np.asarray(v)


def _params(app, seed):
    """JAX's initial params with U(-1, 1) tables (random tables show a
    wrong row or level)."""
    cfg = small_field_config(app, "hash", log2_T=LOG2_T, n_levels=LEVELS)
    params, _ = unbox(fields.init_field(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    params = {**params, "grid": jnp.asarray(rng.uniform(
        -1, 1, params["grid"].shape).astype(np.float32))}
    return cfg, params


def _engine_fn(cfg, settings, with_aux):
    """The JAX engine's bucket function (``serve/engine.py`` ``_get_fn``)."""
    mtile = pipeline.make_multi_scene_tile_fn(cfg, settings,
                                              with_aux=with_aux)

    def fn(stacked, scene_id, cam, pixel_ids, mask):
        out = mtile(stacked, scene_id, cam, pixel_ids)
        if with_aux:
            rgb, aux = out
            return jnp.where(mask[:, None], rgb, 0.0), aux
        return jnp.where(mask[:, None], out, 0.0)
    return fn


def tile_pixel_ids():
    return np.array([r * SIDE + c for r in (6, 7, 8, 9, 4, 5, 10, 11)
                     for c in range(4, 12)], np.int32)


def main(out_path):
    assert len(jax.devices()) == 4, jax.devices()
    out = {}
    mesh = jax.make_mesh((4,), ("data",))
    for shape in ((4, 1), (2, 2), (1, 4)):
        m = jax.make_mesh(shape, ("data", "model"))
        out[f"shard_count/{shape[0]}x{shape[1]}"] = np.int64(
            sharding.pixel_shard_count(m))

    cfg, params = _params("nerf", 0)
    grid = occupancy.build_occupancy_from_fn(
        lambda p: scenes.volume_field(p * 4.0 - 2.0)[:, 3], res=16,
        threshold=0.01)
    _flat(params, "nerf/params/", out)
    _flat(grid, "nerf/grid/", out)
    cam = scenes.default_camera(SIDE, SIDE)
    ids = tile_pixel_ids()
    out["tile/pixel_ids"] = ids

    dense = pipeline.RenderSettings(tile_pixels=TILE, n_samples=SAMPLES)
    culled = pipeline.RenderSettings(tile_pixels=TILE, n_samples=SAMPLES,
                                     occupancy=True, sample_budget=BUDGET)
    stacked = pipeline.stack_scene_params([occupancy.attach(params, grid)])
    mask = np.arange(TILE) < N_VALID
    fn = jax.jit(sharding.shard_tile_fn(_engine_fn(cfg, dense, False),
                                        mesh))
    out["tile/dense_rgb"] = np.asarray(fn(stacked, 0, cam, ids, mask))
    fn = jax.jit(sharding.shard_tile_fn(_engine_fn(cfg, culled, True),
                                        mesh, with_aux=True))
    rgb, rows = fn(stacked, 0, cam, ids, np.ones(TILE, bool))
    out["tile/culled_rgb"] = np.asarray(rgb)
    out["tile/culled_rows"] = np.asarray(rows)

    engine = RenderEngine(dense, mesh=mesh)
    engine.add_scene("s0", cfg, params)
    engine.warmup()
    out["engine/frame"] = engine.render_frame("s0", cam)

    k_init, k_data = train._data_keys(0)
    for app, n in DP_BATCH.items():
        acfg, aparams = _params(app, 1)
        batch = train.make_batch(acfg, jax.random.fold_in(k_data, 0), n,
                                 scenes.default_camera()
                                 if app == "nerf" else None)
        grad_fn = loop.data_parallel_grad_fn(
            lambda p, b, acfg=acfg: train.field_loss(p, acfg, b), mesh,
            partitioning.DEFAULT_RULES)
        loss, grads = jax.jit(grad_fn)(aparams, batch)
        _flat(aparams, f"dp/{app}/params/", out)
        _flat(batch, f"dp/{app}/batch/", out)
        _flat(grads, f"dp/{app}/grads/", out)
        out[f"dp/{app}/loss"] = np.asarray(loss)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
