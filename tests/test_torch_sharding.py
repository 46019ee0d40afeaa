"""repro_torch's data parallelism (``launch/mesh.py``,
``common/partitioning.py``, ``serve/sharding.py``, the engine's ``mesh=``,
``train/loop.data_parallel_grad_fn``, ``train_field(mesh=)``, the
launcher's ``--shard``) against the JAX package's, on the CPU.

The JAX side runs once, in a subprocess on four forced host devices
(``tests/jax_sharding_reference.py``: JAX fixes its device count when it
starts), and writes its sharded outputs with their inputs to an ``.npz``.
The port's side runs on meshes that repeat the CPU four times: the same
split, the same per-shard work, one after another.

Bars: sharded frames within 1e-6 of the JAX package's sharded frames and
of the port's own unsharded ones (the engine's frame within 1e-5 of the
JAX engine's, the bar of ``test_torch_serve.py``); data-parallel
gradients within 1e-5 (the JAX data-parallel test's bar); shard counts and
sample rows exact; loss curves within 1e-5 of their size.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.common import partitioning as jpart
from repro.core import pipeline as jpipeline
from repro.core import train as jtrain
from repro.launch import serve as jserve
from repro.serve import sharding as jsharding
from repro_torch.common import partitioning as tpart
from repro_torch.core import fields as tfields
from repro_torch.core import pipeline
from repro_torch.core import train as ttrain
from repro_torch.data import scenes
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.serve import RenderEngine, sharding
from repro_torch.train import compression as tcomp
from repro_torch.train import loop as tloop
from repro_torch.train import optim as toptim
from tests import jax_sharding_reference as R
from tests.test_torch_grad import _cfgs, _t_batch, jax_start

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FRAME_TOL = 1e-6
ENGINE_TOL = 1e-5
GRAD_TOL = 1e-5
LOSS_TOL = 1e-5


def _mesh(shape=(4,), names=("data",)):
    """A mesh repeating the CPU: the port's forced host devices."""
    return tmesh.Mesh(np.full(shape, CPU, dtype=object), names)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's sharded outputs (one subprocess, ~20 s)."""
    path = tmp_path_factory.mktemp("jax_sharding") / "ref.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, "-m", "tests.jax_sharding_reference", str(path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as data:
        return dict(data)


def _tree(ref, prefix):
    """The nested numpy tree stored under ``prefix`` in the reference."""
    tree = {}
    for key, v in ref.items():
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def _nerf(ref):
    """(port config, the reference's nerf params with its grid attached,
    on the CPU)."""
    _, ct = _cfgs("nerf", R.LOG2_T, R.LEVELS)
    params = {**_tree(ref, "nerf/params/"),
              "occupancy": _tree(ref, "nerf/grid/")}
    return ct, tfields.from_jax_params(params, ct, "cpu")


def _engine_fn(cfg, settings, with_aux):
    """The port engine's bucket function, as ``RenderEngine._get_fn``
    builds it (and the reference script's JAX twin)."""
    mtile = pipeline.make_multi_scene_tile_fn(cfg, settings,
                                              with_aux=with_aux)

    def fn(stacked, scene_id, cam, pixel_ids, mask, n_valid=None):
        out = mtile(stacked, scene_id, cam, pixel_ids, n_valid)
        if with_aux:
            rgb, aux = out
            return torch.where(mask[:, None], rgb, 0.0), aux
        return torch.where(mask[:, None], out, 0.0)
    return fn


_DENSE = pipeline.RenderSettings(tile_pixels=R.TILE, n_samples=R.SAMPLES)
_CULLED = dataclasses.replace(_DENSE, occupancy=True,
                              sample_budget=R.BUDGET)


# ----------------------------------------------------------- partitioning
def test_partitioning_rules_match_jax():
    assert tpart.DEFAULT_RULES.rules == jpart.DEFAULT_RULES.rules
    for name in ("baseline", "sp", "nosp", "noz", "ep2d", "tinydp"):
        assert tpart.rule_preset(name).rules == jpart.rule_preset(name).rules
    rules = tpart.DEFAULT_RULES.copy_with(field_batch="model")
    assert rules.mesh_axes("field_batch") == "model"
    assert tpart.DEFAULT_RULES.mesh_axes("field_batch") == (
        "pod", "data", "model")
    assert rules.mesh_axes(None) is None and rules.mesh_axes("nope") is None


@pytest.mark.parametrize("axes", [None, "data", "pod", ("pod", "data"),
                                  ("pod", "data", "model"), ("model",)])
def test_present_axes_and_sizes_match_jax(axes):
    tm = _mesh((2, 2), ("data", "model"))
    jm = jax.make_mesh((1, 1), ("data", "model"))
    got = tpart.present_axes(tm, axes)
    assert got == jpart.present_axes(jm, axes)
    assert tpart._axes_size(tm, got) == (1 if got is None else
                                         2 ** (1 if isinstance(got, str)
                                               else len(got)))


# ------------------------------------------------------------------- mesh
def test_mesh_shape_devices_and_guards(monkeypatch):
    m = _mesh((2, 2), ("data", "model"))
    assert m.shape == {"data": 2, "model": 2}
    assert list(m.shape) == ["data", "model"] and m.size == 4
    assert m.devices == [CPU] * 4 and tmesh.mesh_chip_count(m) == 4
    with pytest.raises(ValueError, match="axis names"):
        tmesh.Mesh([CPU, CPU], ("data", "model"))
    with pytest.raises(ValueError, match="axis names"):
        tmesh.Mesh([[CPU], [CPU]], ("data", "data"))
    # a CUDA device: none here, and past the cards there are
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.Mesh(["cuda:0"], ("data",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="does not exist"):
        tmesh.Mesh(["cuda:0", "cuda:1"], ("data",))
    assert tmesh.Mesh(["cuda:0", "cuda:0"], ("data",)).devices == [
        torch.device("cuda", 0)] * 2


def test_make_local_mesh_clamps_as_jax(monkeypatch):
    m = tmesh.make_local_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.devices == [CPU]
    assert tmesh.make_local_mesh(4, 2, device="cpu").shape == {
        "data": 1, "model": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for (d, mm), shape in (((2, 2), (2, 2)), ((4, 1), (4, 1)),
                           ((8, 1), (4, 1)), ((3, 2), (4, 1))):
        m = tmesh.make_local_mesh(d, mm)
        assert tuple(m.shape.values()) == shape
        assert m.devices == [torch.device("cuda", i) for i in range(4)]
    # a named card comes first, the others follow in index order
    assert tmesh.make_local_mesh(device="cuda:1").devices == [
        torch.device("cuda", 1)]
    assert tmesh.make_local_mesh(4, device="cuda:2").devices == [
        torch.device("cuda", i) for i in (2, 3, 0, 1)]
    with pytest.raises(ValueError, match="does not exist"):
        tmesh.make_local_mesh(device="cuda:4")
    with pytest.raises(RuntimeError, match="CUDA"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        tmesh.make_local_mesh()


# ---------------------------------------------------------------- shards
@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_pixel_shard_count_matches_jax(ref, shape):
    m = _mesh(shape, ("data", "model"))
    assert sharding.pixel_shard_count(m) == int(
        ref[f"shard_count/{shape[0]}x{shape[1]}"]) == 4
    assert sharding.pixel_shard_count(
        m, tpart.DEFAULT_RULES.copy_with(field_batch="model")) == shape[1]
    assert sharding.pixel_shard_count(
        m, tpart.DEFAULT_RULES.copy_with(field_batch=None)) == 1


def test_shard_devices_follow_the_rules_axis_order():
    """As in a PartitionSpec, the rules' first axis is the major one; an
    axis the split does not use replicates (its first device runs)."""
    devs = np.array([[f"d{r}m{c}" for c in range(2)] for r in range(3)],
                    dtype=object)
    m = _mesh((3, 2), ("data", "model"))
    m.device_grid = devs              # labels in place of devices
    assert tmesh.shard_devices(m) == ["d0m0", "d0m1", "d1m0", "d1m1",
                                         "d2m0", "d2m1"]
    swapped = tpart.DEFAULT_RULES.copy_with(field_batch=("model", "data"))
    assert tmesh.shard_devices(m, swapped) == [
        "d0m0", "d1m0", "d2m0", "d0m1", "d1m1", "d2m1"]
    data_only = tpart.DEFAULT_RULES.copy_with(field_batch="data")
    assert tmesh.shard_devices(m, data_only) == ["d0m0", "d1m0", "d2m0"]
    assert tmesh.shard_devices(
        m, tpart.DEFAULT_RULES.copy_with(field_batch=None)) is None


def test_check_sample_budget_matches_jax():
    for kw in (dict(occupancy=True, sample_budget=128),
               dict(occupancy=True, sample_budget=130),
               dict(occupancy=True), dict(sample_budget=130)):
        results = []
        for mod, settings in (
                (jsharding, jpipeline.RenderSettings(tile_pixels=64, **kw)),
                (sharding, pipeline.RenderSettings(tile_pixels=64, **kw))):
            try:
                mod.check_sample_budget(settings, 4)
                results.append(None)
            except ValueError as e:
                results.append(str(e))
        assert results[0] == results[1], kw
    with pytest.raises(ValueError, match="sample_budget=130 not divisible"):
        sharding.check_sample_budget(
            pipeline.RenderSettings(occupancy=True, sample_budget=130), 4)


# ------------------------------------------------------------ tile split
def test_sharded_dense_tile_matches_jax(ref):
    """A partly valid tile (40 of 64 pixels: shard 2 in part, shard 3 not
    at all) through the 4-shard split: within 1e-6 of the JAX package's
    shard_map and of the port's unsharded tile; the pad lanes are 0."""
    ct, params = _nerf(ref)
    stacked = pipeline.stack_scene_params([params])
    ids = torch.from_numpy(ref["tile/pixel_ids"].astype(np.int64))
    mask = torch.arange(R.TILE) < R.N_VALID
    cam = scenes.default_camera(R.SIDE, R.SIDE)
    fn = _engine_fn(ct, _DENSE, False)
    got = sharding.shard_tile_fn(fn, _mesh())(stacked, 0, cam, ids, mask,
                                              R.N_VALID).numpy()
    np.testing.assert_allclose(got, ref["tile/dense_rgb"], rtol=0,
                               atol=FRAME_TOL)
    np.testing.assert_allclose(got, fn(stacked, 0, cam, ids, mask).numpy(),
                               rtol=0, atol=FRAME_TOL)
    assert not got[R.N_VALID:].any() and got[:R.N_VALID].any()


def test_sharded_culled_tile_sheds_per_shard_as_jax(ref):
    """The culled tile at a budget of 16 samples a shard: shards 0 and 1
    overflow, 2 and 3 do not. Pixels within 1e-6 of JAX's, the (4, 3)
    rows equal to JAX's, and the shards that did not overflow equal the
    unsharded tile's pixels."""
    ct, params = _nerf(ref)
    stacked = pipeline.stack_scene_params([params])
    ids = torch.from_numpy(ref["tile/pixel_ids"].astype(np.int64))
    mask = torch.ones(R.TILE, dtype=torch.bool)
    cam = scenes.default_camera(R.SIDE, R.SIDE)
    fn = _engine_fn(ct, _CULLED, True)
    rgb, rows = sharding.shard_tile_fn(fn, _mesh(), with_aux=True)(
        stacked, 0, cam, ids, mask, R.TILE)
    np.testing.assert_allclose(rgb.numpy(), ref["tile/culled_rgb"], rtol=0,
                               atol=FRAME_TOL)
    assert np.array_equal(rows.numpy(), ref["tile/culled_rows"])
    assert rows.shape == (4, 3) and (rows[:2, 2] > 0).all() \
        and (rows[2:, 2] == 0).all() and (rows[2:, 0] > 0).all()
    # the whole tile at the full budget: nothing is dropped anywhere
    full = dataclasses.replace(_CULLED, sample_budget=None)
    dense_rgb, row = _engine_fn(ct, full, True)(stacked, 0, cam, ids, mask)
    half = R.TILE // 2
    np.testing.assert_allclose(rgb[half:].numpy(), dense_rgb[half:].numpy(),
                               rtol=0, atol=FRAME_TOL)
    assert float(row[0, 0]) == float(rows[:, 0].sum())


def test_sharded_rows_count_each_shards_valid_pixels():
    """Each shard's n_valid is its own piece's: a tile with 40 of 64 valid
    pixels counts 16, 16, 8 and 0 pixels' samples; the summed row equals
    the unsharded tile's (no shard overflows)."""
    cj, ct, p0, _ = jax_start("nerf", 8, log2_T=R.LOG2_T, n_levels=R.LEVELS)
    from repro_torch.core import occupancy
    params = occupancy.attach(tfields.from_jax_params(p0, ct, "cpu"),
                              occupancy.all_occupied(8, "cpu"))
    stacked = pipeline.stack_scene_params([params])
    settings = dataclasses.replace(_CULLED, sample_budget=None)
    fn = _engine_fn(ct, settings, True)
    ids = torch.arange(R.TILE)
    mask = ids < 40
    cam = scenes.default_camera(8, 8)
    rgb, rows = sharding.shard_tile_fn(fn, _mesh(), with_aux=True)(
        stacked, 0, cam, ids, mask, 40)
    assert rows[:, 1].tolist() == [16 * R.SAMPLES, 16 * R.SAMPLES,
                                   8 * R.SAMPLES, 0.0]
    rgb1, row1 = fn(stacked, 0, cam, ids, mask, 40)
    assert torch.equal(rows.sum(0), row1[0])
    assert torch.equal(rgb, rgb1)


def test_replicas_share_the_stacks_storage():
    """On a mesh that repeats the stack's device each shard's replica is
    the stack's own tensors (no copy); a new stack is replicated anew."""
    cj, ct, p0, _ = jax_start("gia", 8, log2_T=R.LOG2_T, n_levels=R.LEVELS)
    stacked = pipeline.stack_scene_params([tfields.from_jax_params(
        p0, ct, "cpu")])
    fn = sharding.shard_tile_fn(_engine_fn(ct, _DENSE, False), _mesh())
    ids = torch.arange(R.TILE)
    cam = scenes.default_camera(8, 8)
    fn(stacked, 0, cam, ids, ids < R.TILE)
    assert list(fn.replicas) == [CPU] and fn.devices == [CPU] * 4
    rep = fn.replicas[CPU]
    for k in ("grid",):
        assert rep[k].data_ptr() == stacked[k].data_ptr()
    for k, w in stacked["mlp"].items():
        assert rep["mlp"][k] is w
    again = pipeline.stack_scene_params([tfields.from_jax_params(
        p0, ct, "cpu")])
    fn(again, 0, cam, ids, ids < R.TILE)
    assert fn.replicas[CPU]["grid"].data_ptr() == again["grid"].data_ptr()


# ---------------------------------------------------------------- engine
def test_sharded_engine_matches_unsharded_and_jax(ref):
    """A 16x16 frame through the 4-shard engine: within 1e-6 of the port's
    unsharded engine and 1e-5 of the JAX package's sharded engine; a
    frame that ends in a partial tile too."""
    ct, params = _nerf(ref)
    params = {k: v for k, v in params.items() if k != "occupancy"}
    sharded = RenderEngine(_DENSE, mesh=_mesh(), device="cpu")
    plain = RenderEngine(_DENSE, device="cpu")
    for e in (sharded, plain):
        e.add_scene("s0", ct, params)
        e.warmup()
    cam = scenes.default_camera(R.SIDE, R.SIDE)
    got = sharded.render_frame("s0", cam)
    np.testing.assert_allclose(got, plain.render_frame("s0", cam), rtol=0,
                               atol=FRAME_TOL)
    np.testing.assert_allclose(got, ref["engine/frame"], rtol=0,
                               atol=ENGINE_TOL)
    odd = scenes.default_camera(5, 7)
    np.testing.assert_allclose(sharded.render_frame("s0", odd),
                               plain.render_frame("s0", odd), rtol=0,
                               atol=FRAME_TOL)
    assert sharded.stats()["n_traces_total"] == 1


def test_sharded_culled_engine_sums_the_shards_rows(ref):
    """stats() sums the shards' rows: the live share and dropped samples
    of the culled tile equal the rows' sums."""
    ct, params = _nerf(ref)
    eng = RenderEngine(_CULLED, mesh=_mesh(), device="cpu")
    eng.add_scene("s0", ct, params)
    eng.warmup()
    from repro_torch.serve import RenderRequest
    eng.submit(RenderRequest("s0", scenes.default_camera(R.SIDE, R.SIDE),
                             ref["tile/pixel_ids"])).result()
    st = eng.stats()
    rows = ref["tile/culled_rows"]
    assert st["samples_total"] == rows[:, 1].sum()
    assert st["samples_dropped"] == rows[:, 2].sum() > 0
    assert st["live_sample_frac"] == rows[:, 0].sum() / rows[:, 1].sum()


def test_engine_refuses_what_does_not_divide():
    """The JAX constructor's two guards, with its messages, and a mesh
    without the engine's device."""
    with pytest.raises(ValueError, match="tile_pixels=66 not divisible by "
                                         "the mesh's 4 pixel shards"):
        RenderEngine(pipeline.RenderSettings(tile_pixels=66), mesh=_mesh(),
                     device="cpu")
    with pytest.raises(ValueError, match="sample_budget=130 not divisible "
                                         "by the mesh's 4 pixel shards"):
        RenderEngine(pipeline.RenderSettings(tile_pixels=64, occupancy=True,
                                             sample_budget=130),
                     mesh=_mesh(), device="cpu")
    RenderEngine(pipeline.RenderSettings(tile_pixels=66), mesh=_mesh(
        (1, 1), ("data", "model")), device="cpu")
    meta = _mesh()
    meta.device_grid = np.full(4, torch.device("meta"), dtype=object)
    with pytest.raises(ValueError, match="not in the mesh"):
        RenderEngine(pipeline.RenderSettings(tile_pixels=64), mesh=meta,
                     device="cpu")


# -------------------------------------------------------------- training
@pytest.mark.parametrize("app", ["nerf", "gia"])
def test_data_parallel_grads_match_jax(ref, app):
    """data_parallel_grad_fn on a 4-shard mesh, on the reference's params
    and batch: loss and every gradient within 1e-5 of JAX's shard_map +
    pmean and of the port's unsharded gradient, on the params' device."""
    _, ct = _cfgs(app, R.LOG2_T, R.LEVELS)
    params = tfields.from_jax_params(_tree(ref, f"dp/{app}/params/"), ct,
                                     "cpu")
    batch = _t_batch(_tree(ref, f"dp/{app}/batch/"))

    def loss_fn(p, b):
        return ttrain.field_loss(p, ct, b)
    loss, grads = tloop.data_parallel_grad_fn(
        loss_fn, _mesh(), tpart.DEFAULT_RULES)(params, batch)
    l1, g1 = tloop.value_and_grad(loss_fn, params, batch)
    np.testing.assert_allclose(float(loss), float(ref[f"dp/{app}/loss"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(l1), rtol=0, atol=1e-6)
    jg = _tree(ref, f"dp/{app}/grads/")
    n = 0
    for path, g in _items(grads):
        np.testing.assert_allclose(g.numpy(), _get(jg, path), rtol=0,
                                   atol=GRAD_TOL, err_msg=path)
        np.testing.assert_allclose(g.numpy(), _get(g1, path).numpy(),
                                   rtol=0, atol=GRAD_TOL, err_msg=path)
        assert g.device == CPU and float(g.abs().max()) > 0
        n += 1
    assert n == len(list(_items(g1)))


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_data_parallel_grad_fn_refuses_unequal_shards():
    _, ct, p0, batch = jax_start("gia", 10)
    fn = tloop.data_parallel_grad_fn(
        lambda p, b: ttrain.field_loss(p, ct, b), _mesh())
    with pytest.raises(ValueError, match="equal"):
        fn(tfields.from_jax_params(p0, ct, "cpu"), _t_batch(batch(0)))


def test_one_shard_is_the_plain_gradient():
    """Without a mesh, or on a one-shard mesh (or rules that bind none of
    its axes), the gradient function is value_and_grad itself."""
    _, ct, p0, batch = jax_start("gia", 16)
    params = tfields.from_jax_params(p0, ct, "cpu")
    b = _t_batch(batch(0))
    l1, g1 = tloop.value_and_grad(lambda p, bb: ttrain.field_loss(p, ct, bb),
                                  params, b)
    for mesh, rules in ((None, None), (_mesh((1, 1), ("data", "model")),
                                       None),
                        (_mesh(), tpart.DEFAULT_RULES.copy_with(
                            field_batch="model"))):
        loss, g = tloop.data_parallel_grad_fn(
            lambda p, bb: ttrain.field_loss(p, ct, bb), mesh, rules)(
            params, b)
        assert torch.equal(loss, l1) and torch.equal(g["grid"], g1["grid"])


@pytest.mark.parametrize("kw", [dict(), dict(grad_accum=2),
                                dict(compression="topk")],
                         ids=["plain", "grad_accum", "topk"])
def test_train_field_mesh_loss_curves_match_jax(kw):
    """Six steps of gia data-parallel on a 4-shard mesh (each micro-batch
    split, with grad_accum; top-k after the reduce) against the JAX
    package's unsharded train_field with the same knobs, fed the same
    params and batches: every loss within 1e-5 of its size."""
    cj, ct, p0, batch = jax_start("gia", 64)
    _, jh = jtrain.train_field(cj, steps=6, batch_size=64, seed=0,
                               log_every=1, chunk_steps=4, **kw)
    _, th = ttrain.train_field(
        ct, steps=6, log_every=1, chunk_steps=4, mesh=_mesh(),
        rules=tpart.DEFAULT_RULES, device="cpu",
        params=tfields.from_jax_params(p0, ct, "cpu"),
        batch_fn=lambda i: _t_batch(batch(i)), **kw)
    assert [s for s, _ in th] == [s for s, _ in jh] == list(range(6))
    for (_, a), (_, b) in zip(jh, th):
        assert abs(b - float(a)) <= LOSS_TOL * abs(float(a))


def test_compression_runs_after_the_reduce():
    """One data-parallel step with top-k: the error feedback is what top-k
    did not send of the shards' mean gradient, exactly."""
    _, ct, p0, batch = jax_start("gia", 128)
    params = tfields.from_jax_params(p0, ct, "cpu")
    b = _t_batch(batch(0))

    def loss_fn(p, bb):
        return ttrain.field_loss(p, ct, bb)
    _, g = tloop.data_parallel_grad_fn(loss_fn, _mesh())(params, b)
    step = tloop.make_scanned_step(loss_fn, toptim.AdamConfig(),
                                   compression="topk", mesh=_mesh())
    state, _ = step(tloop.init_train_state(params, compression="topk"), 0, b)
    kept, efb = tcomp.compress_topk(g["grid"], torch.zeros_like(g["grid"]),
                                    0.05)
    assert torch.equal(state["efb"]["grid"], efb)
    assert torch.equal(kept + efb, g["grid"])


def test_train_field_mesh_device_must_be_the_first():
    _, ct, _, _ = jax_start("gia", 8)
    meta = _mesh()
    with pytest.raises(ValueError, match="first device"):
        ttrain.train_field(ct, steps=1, batch_size=8, mesh=meta,
                           device="meta")


# --------------------------------------------------------------- launcher
def test_launcher_shard_logs_the_jax_events(capsys):
    """``--shard`` on a tiny nvr run: the port's launcher and the JAX one
    log the same events with the same keys, and serve every request."""
    argv = ["--app", "nvr", "--shard", "--train-steps", "2", "--requests",
            "2", "--tile-pixels", "64", "--height", "16", "--width", "16"]
    runs = {}
    for name, main, extra in (("jax", jserve.main, []),
                              ("torch", tserve.main, ["--device", "cpu"])):
        capsys.readouterr()
        main(argv + extra)
        runs[name] = [json.loads(line) for line in
                      capsys.readouterr().out.strip().splitlines()]

    def shape(recs):
        return [(r["event"], r["logger"], r["level"], sorted(r))
                for r in recs]
    assert shape(runs["torch"]) == shape(runs["jax"])
    served = [r for r in runs["torch"] if r["event"] == "served"][0]
    assert served["n_requests"] == 2 and served["compiles"] == 1


def test_launcher_shard_meshes_the_named_card(monkeypatch):
    """``--device cuda:1 --shard`` on two (mocked) cards: the launcher's
    1 x 1 mesh is cuda:1, so the engine, built on it, accepts it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    built = []

    class Built(Exception):
        pass

    class Engine(RenderEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)
            raise Built

    monkeypatch.setattr("repro_torch.serve.RenderEngine", Engine)
    with pytest.raises(Built):
        tserve.main(["--device", "cuda:1", "--shard"])
    (engine,) = built
    assert engine.device == torch.device("cuda", 1)
    assert engine.mesh.shape == {"data": 1, "model": 1}
    assert engine.mesh.devices == [torch.device("cuda", 1)]
