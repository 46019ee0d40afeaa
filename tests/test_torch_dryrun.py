"""The port's dry run (``launch/dryrun.py``) and the modules it needs
(``configs/registry.input_specs``, ``core/pipeline.make_render_step``,
``parallel/api.step_collective_bytes``, ``launch/mesh.
make_production_mesh``) against the JAX package.

The JAX oracles that need a mesh or the JAX dry run's module run once, in
a subprocess on forced host devices (``tests/jax_dryrun_reference.py``,
~7 s); the rest run in this process. Counted FLOPs are the port's
matrix products (``launch/roofline.Counter``) against the ``dot_general``
FLOPs of the JAX step's jaxpr, less the RMS norms' x . x dots, which the
port computes elementwise.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as jregistry
from repro.configs.shapes import shape_applicable as jshape_applicable
from repro.core import pipeline as jpipeline
from repro.core import render as jrender
from repro.launch import roofline as jroofline
from repro_torch.common.partitioning import DEFAULT_RULES, NamedSharding
from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES, ShapeCell, shape_applicable
from repro_torch.core import fields as tfields
from repro_torch.core import pipeline as tpipeline
from repro_torch.data import scenes as tscenes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, MeshShape, make_production_mesh
from repro_torch.parallel import api, collectives as pcoll
from repro_torch.train import optim
from tests.conftest import small_field_config
from tests.torch_lm_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TOL = 1e-5
# counted train FLOPs over the JAX jaxpr's (remat's recomputation on both
# sides): reduced qwen2-7b counts 0.9982 of JAX's; the rest are products
# JAX's loss writes as dots where the port gathers or sums
TRAIN_FLOPS_BAND = (0.99, 1.0)
# the keys JAX's lower_cell adds to its summarize record
JAX_CELL_KEYS = {"rules", "train_overrides", "compile_s", "probe_s",
                 "params_total", "params_active", "probe_meta",
                 "scan_cost_raw", "sharding_fallbacks"}
JAX_FIELD_KEYS = {"compile_s", "fused", "params_total", "n_pixels"}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX oracles (one subprocess, ~7 s)."""
    path = str(tmp_path_factory.mktemp("jax_dryrun") / "ref.json")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, "-m", "tests.jax_dryrun_reference", path],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(path) as f:
        return json.load(f)


def _jax_record_keys():
    class Mem:
        argument_size_in_bytes = output_size_in_bytes = 1
        temp_size_in_bytes = 1
    rec = jroofline.summarize("x", {"flops": 1.0}, Mem(), "", 1, 1.0)
    mem = set(rec.pop("memory_analysis")) - {"fits_v5e_16g"}
    return set(rec), mem | {"fits_h100_80g"}


# ------------------------------------------------------------ input specs
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", registry.list_archs())
def test_input_specs_match_jax(arch, shape):
    got = registry.input_specs(registry.get_config(arch), shape)
    want = jregistry.input_specs(jregistry.get_config(arch), shape)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v
    g, w = dict(flat(got)), dict(flat(want))
    assert list(g) == list(w)
    for k in g:
        assert g[k].device.type == "meta"
        assert tuple(g[k].shape) == tuple(w[k].shape), k
        assert str(g[k].dtype).replace("torch.", "") == str(w[k].dtype), k


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", registry.list_archs())
def test_shape_applicable_matches_jax(arch, shape):
    assert shape_applicable(registry.get_config(arch), shape) == \
        jshape_applicable(jregistry.get_config(arch), shape)


def test_train_overrides_match_jax(ref):
    assert {f"{a}|{s}": v for (a, s), v in dryrun.TRAIN_OVERRIDES.items()} \
        == ref["train_overrides"]


def test_production_meshes_are_jaxs():
    single, multi = (make_production_mesh(multi_pod=m) for m in (False,
                                                                  True))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512


# ---------------------------------------------------------- the render step
def _field_cfgs(app):
    log2_T = 13 if app == "nsdf" else 12
    cj = small_field_config(app, "hash", log2_T=log2_T, n_levels=4)
    ct = tfields.make_field_config(app, "hash")
    ct = ct.with_grid(dataclasses.replace(ct.grid, log2_table_size=log2_T,
                                          n_levels=4))
    return cj, ct


def _np_params(ct, seed):
    if ct.app == "nsdf":            # sphere tracing converges on it
        return tscenes.baked_sdf_params(ct, seed)
    rng = np.random.default_rng(seed)

    def draw(shapes, grid=False):
        if isinstance(shapes, dict):
            return {k: draw(s, k == "grid") for k, s in shapes.items()}
        if grid:
            return rng.uniform(-1, 1, shapes).astype(np.float32)
        return (rng.normal(size=shapes) / np.sqrt(shapes[-2])).astype(
            np.float32)
    return draw(tfields.param_shapes(ct))


@pytest.mark.parametrize("app", ["nerf", "gia", "nsdf"])
def test_render_step_matches_jax(app):
    """``make_render_step`` on a 20 x 24 camera, 96 random pixels, the XLA
    route on the JAX side."""
    cj, ct = _field_cfgs(app)
    p = _np_params(ct, 4)
    cam = tscenes.default_camera(20, 24)
    ids = np.random.default_rng(5).integers(0, 20 * 24, 96)
    got = tpipeline.make_render_step(ct, tpipeline.RenderSettings(), cam)(
        tfields.from_jax_params(p, ct, "cpu"), torch.from_numpy(ids))
    jcam = jrender.Camera(height=cam.height, width=cam.width,
                          focal=cam.focal, c2w=jnp.asarray(cam.c2w))
    want = jpipeline.make_render_step(cj, jpipeline.RenderSettings(), jcam)(
        {k: (jnp.asarray(v) if not isinstance(v, dict) else
             {kk: jnp.asarray(vv) for kk, vv in v.items()})
         for k, v in p.items()}, jnp.asarray(ids, jnp.int32))
    assert got.shape == (96, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_render_step_defaults_to_the_4k_camera():
    """gia's points are the pixels' coordinates on the camera: without a
    camera the step renders the 2160 x 3840 one."""
    _, ct = _field_cfgs("gia")
    params = tfields.from_jax_params(_np_params(ct, 6), ct, "cpu")
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, 2160 * 3840, 64))
    got = tpipeline.make_render_step(ct)(params, ids)
    want = tpipeline.make_render_step(
        ct, cam=tscenes.default_camera(2160, 3840))(params, ids)
    other = tpipeline.make_render_step(
        ct, cam=tscenes.default_camera(2160, 3841))(params, ids)
    assert torch.equal(got, want) and not torch.equal(got, other)


# --------------------------------------------------------- counted FLOPs
@pytest.mark.parametrize("arch", ["qwen2-7b", "olmoe-1b-7b"])
def test_prefill_flops_equal_jax(ref, arch):
    b, s = ref["prefill"]
    counted, _ = dryrun.build_and_count(
        registry.reduced_config(arch), ShapeCell("p", s, b, "prefill"),
        dryrun.ONE_POSITION, DEFAULT_RULES)
    assert counted["flops"] == ref["prefill_dot_flops"][arch]


def test_train_flops_within_band_of_jax(ref):
    b, s = ref["train"]
    (arch, jax_flops), = ref["train_dot_flops"].items()
    counted, _ = dryrun.build_and_count(
        registry.reduced_config(arch), ShapeCell("t", s, b, "train"),
        dryrun.ONE_POSITION, DEFAULT_RULES)
    ratio = counted["flops"] / jax_flops
    assert TRAIN_FLOPS_BAND[0] <= ratio <= TRAIN_FLOPS_BAND[1], ratio


@pytest.mark.parametrize("arch,step", [("h2o-danube-1.8b", "train"),
                                       ("qwen2-7b", "prefill"),
                                       ("olmoe-1b-7b", "decode")])
def test_counted_flops_equal_flop_counter_on_the_cpu(arch, step):
    """The count on meta against ``FlopCounterMode`` over the same step run
    for real on the CPU (the card's check is ``chip_smoke.py``'s)."""
    cfg = dataclasses.replace(registry.reduced_config(arch),
                              act_dtype="float32")
    b, s = 2, 16
    counted, _ = dryrun.build_and_count(cfg, ShapeCell("c", s, b, step),
                                        dryrun.ONE_POSITION, DEFAULT_RULES)
    params = api.init_params(cfg, 0, device=CPU)
    tokens = torch.zeros((b, s), dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        if step == "train":
            state = api.make_train_state(params)
            api.make_train_step(cfg)[0](state, {"tokens": tokens})
        elif step == "prefill":
            cache = api.make_cache(cfg, b, s, device=CPU)
            api.make_prefill_step(cfg, capacity=s, batch_size=b)[0](
                params, {"tokens": tokens}, cache)
        else:
            cache = api.make_cache(cfg, b, s, device=CPU)
            api.make_decode_step(cfg, capacity=s, batch_size=b)[0](
                params, cache, tokens[:, :1], s - 1)
    assert counted["flops"] == fc.get_total_flops()


# ------------------------------------------------------------ memory
def test_argument_bytes_against_jax(ref):
    """Reduced danube's train cell on (2, 2), one position: the JAX
    step's arguments are its param, mu and nu shards, the step counter
    and its batch shard (the batch spec splits tokens over 'data' and
    the sequence over 'model'). The port's are its master, mu and nu
    shards and its row's whole sequence (every rank of the row's group
    reads the row's tokens); its state, ``train_state_bytes``, adds the
    gradient's shard, the compute copy of its shards, the final norm's
    and unembedding's slices the forward keeps for the backward and the
    largest block's copied slice with that slice's gradient, which the
    step makes. The difference is exactly the batch terms and the
    counter."""
    (arch, jax_args), = ref["argument_bytes"].items()
    b, s = ref["train"]
    cfg = registry.reduced_config(arch)
    mesh = MeshShape(("data", "model"), (2, 2))
    counted, meta = dryrun.build_and_count(
        cfg, ShapeCell("t", s, b, "train"), mesh, DEFAULT_RULES)
    p = meta["position"]
    shard = api.shard_param_bytes(cfg, mesh)[p]
    shapes, specs = api.param_specs(cfg, mesh, DEFAULT_RULES)
    cast = sum(np.prod(NamedSharding(mesh, sp).shard_shape(l.shape)) * 2
               for l, sp in zip(optim.tree_leaves(shapes),
                                optim.tree_leaves(specs))
               if l.ndim >= 2)
    terms = api.train_bytes(cfg, mesh=mesh)
    block, held = terms["block"][p], terms["held"][p]
    assert 0 < block < shard and 0 < held < shard
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    tspec = api.batch_specs(cfg, {"tokens": tokens}, mesh,
                            DEFAULT_RULES)["tokens"]
    jax_batch = int(np.prod(NamedSharding(mesh, tspec).shard_shape(
        (b, s)))) * 4
    row = b // meta["rows"] * s * 4
    assert meta["state_bytes"] == api.train_state_bytes(
        cfg, mesh=mesh)[p] == 4 * shard + cast + held + 2 * block
    assert counted["argument_bytes"] == 3 * shard + row
    assert jax_args == 3 * shard + 4 + jax_batch
    assert counted["argument_bytes"] - jax_args == row - jax_batch - 4


def test_step_collective_bytes_against_a_cpu_mesh():
    """Reduced danube in f32 on a CPU (2, 2) mesh, one train step: what
    its group collectives, block gathers and their backward's
    reduce-scatters tally at each position, against
    ``step_collective_bytes`` (the first row's first rank counted on meta
    tensors), on the mesh and on a stand-in of its shape."""
    cfg = dataclasses.replace(registry.reduced_config("h2o-danube-1.8b"),
                              act_dtype="float32")
    mesh = Mesh(np.array([CPU] * 4, dtype=object).reshape(2, 2),
                ("data", "model"))
    batch, seq = 4, 16
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)))
    state = api.make_train_state(api.init_params(cfg, 0, mesh,
                                                 DEFAULT_RULES))
    with pcoll.tally() as moved:
        api.make_train_step(cfg, mesh, DEFAULT_RULES)[0](state,
                                                         {"tokens": tokens})
    want = api.step_collective_bytes(cfg, mesh, DEFAULT_RULES, batch,
                                     seq=seq)
    assert [api._tally_entry(moved, p) for p in range(4)] == want
    assert all(want[0][k] > 0 for k in ("all-gather", "all-reduce",
                                        "reduce-scatter"))
    assert want[0]["links"] == dict.fromkeys(
        ("all-gather", "all-reduce", "reduce-scatter"), "nvlink")
    assert api.step_collective_bytes(
        cfg, MeshShape(("data", "model"), (2, 2)), DEFAULT_RULES, batch,
        seq=seq) == want


# ------------------------------------------------------------- the CLI
def test_main_writes_records_and_resumes(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    argv = ["--arch", "whisper-base", "--shape", "decode_32k",
            "--mesh", "both", "--out", str(out)]
    assert dryrun.main(argv) == 0
    first = out.read_text()
    recs = json.loads(first)
    top, mem = _jax_record_keys()
    assert set(recs) == {"whisper-base/decode_32k/single",
                         "whisper-base/decode_32k/multi"}
    for rec in recs.values():
        assert top | JAX_CELL_KEYS <= set(rec)
        assert mem <= set(rec["memory_analysis"])
        assert "fits_v5e_16g" not in rec["memory_analysis"]
        assert rec["probe_meta"] == {"probe": "exact"}
        assert rec["bound_s"] > 0 and rec["memory_analysis"]["fits_h100_80g"]
        assert rec["memory_analysis"]["state_bytes"] == api.param_bytes(
            registry.get_config("whisper-base"), torch.bfloat16,
            mesh=make_production_mesh(multi_pod=rec["chips"] == 512))[
                rec["position"]]
    capsys.readouterr()
    assert dryrun.main(argv) == 0
    assert out.read_text() == first
    assert capsys.readouterr().out.count('"cached_skip"') == 2
    # a skipped cell is recorded as the JAX dry run records it
    assert dryrun.lower_cell("yi-6b", "long_500k", False) == {
        "cell": "yi-6b/long_500k",
        "skipped": shape_applicable(registry.get_config("yi-6b"),
                                    "long_500k")}


def test_main_fields(tmp_path):
    out = tmp_path / "fields.json"
    assert dryrun.main(["--fields", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert len(recs) == 12
    top, mem = _jax_record_keys()
    for key, rec in recs.items():
        assert top | JAX_FIELD_KEYS <= set(rec) and mem <= set(
            rec["memory_analysis"]), key
        assert rec["bound_s"] > 0 and rec["memory_analysis"]["fits_h100_80g"]
        assert rec["n_pixels"] == 1 << 21
        assert rec["pixels_per_position"] == 8192
    launches = {k: {n: w["launches"] for n, w in r["kernels"].items()}
                for k, r in recs.items()}
    assert launches["field-nerf-hash/single"] == {
        "field_fwd": 1, "mlp_fwd": 1, "composite_fwd": 1}
    assert launches["field-nvr-dense/single"] == {"field_fwd": 1,
                                                  "composite_fwd": 1}
    assert launches["field-gia-tiled/single"] == {"field_fwd": 1}
    # 48 sphere-trace steps, the hit points, 6 for the normal
    assert launches["field-nsdf-hash/single"] == {"field_fwd": 55}
