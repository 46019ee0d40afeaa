"""The tensor-parallel train step (``parallel/api.make_value_and_grad`` on
a mesh, ``models/lm.loss_fn_tp``, ``models/encdec.loss_fn_tp``, the
vocab-parallel CE, ``parallel/sharded.gather_region``'s backward) on the
CPU repeated as (1, 4) and (2, 2) meshes.

The oracle is the port's one-device step: every reduced arch's loss and
every gradient leaf (gathered from its shards) within 1e-5 in f32, with
the unembedding widened to f32 on both sides (``tests/torch_lm_f32.py``),
under full remat, and under "dots" and "none" on one dense arch. No leaf
is gathered whole: each block's slices come from ``gather_region``, are
below the whole leaf where 'model' splits it, are dropped before the next
block's are gathered, and are gathered again by the backward under full
remat. The vocab-parallel CE against ``lm.chunked_cross_entropy``, and
gradchecks in f64 of the gather's backward and of the CE; the MoE's
load-balance term once per row; the memory plans of the large archs on
80 GB stand-ins; the dry run's count of one rank; the collectives a step
tallies against its meta count. (The JAX package's sharded gradients are
the oracle in ``tests/test_torch_lm_shard_numerics.py``.)
"""
import dataclasses
import weakref

import numpy as np
import pytest
import torch

from repro_torch.common.partitioning import (DEFAULT_RULES, NamedSharding,
                                             PartitionSpec, rule_preset)
from repro_torch.configs import registry
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import Mesh, MeshShape, make_production_mesh
from repro_torch.models import layers, lm
from repro_torch.parallel import api, collectives as coll, sharded as sh, tp
from repro_torch.train import optim
from tests.torch_lm_f32 import f32_unembed
from tests.torch_lm_parity import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = 1e-5
B, S = 4, 16
MESHES = ((1, 4), (2, 2))


def _mesh(shape):
    return Mesh(np.array([CPU] * 4, dtype=object).reshape(shape),
                ("data", "model"))


def _batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    if cfg.frontend == "vision":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        pos[1] //= 2
        pos[2] %= 4
        return {"embeddings": torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)), "labels": toks,
            "positions": torch.from_numpy(pos)}
    batch = {"tokens": toks}
    if cfg.is_encdec:
        batch["enc_embeddings"] = torch.from_numpy(rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32))
    return batch


def _f32(arch, **changes):
    return dataclasses.replace(registry.reduced_config(arch),
                               act_dtype="float32", **changes)


@pytest.fixture(scope="module")
def one_device():
    """Each config's one-device params, loss, aux and gradients."""
    out = {}

    def get(cfg):
        key = (cfg.name, cfg.remat)
        if key not in out:
            params = api.init_params(cfg, 0, device="cpu")
            with f32_unembed():
                (loss, aux), grads = api.make_value_and_grad(cfg)(
                    params, _batch(cfg))
            out[key] = (loss, aux, grads)
        return out[key]
    return get


class _Watch:
    """``tp.gather_region`` and ``BlockSource.block`` wrapped: no whole
    gather (``sh.gather`` fails), a slice of a leaf that 'model' splits is
    below the whole leaf, the copied slices alive at a block's gather are
    that block's only (besides those the forward keeps for the backward,
    ``api.train_held_keys``), and each block's gathers are counted."""

    def __init__(self, monkeypatch, cfg):
        self.live, self.key, self.blocks = [], None, {}
        # without remat a block's slices live on in its saved tensors
        self.liveness = cfg.remat != "none"
        self.held = api.train_held_keys(cfg)
        self.real = tp.gather_region
        monkeypatch.setattr(tp, "gather_region", self)
        monkeypatch.setattr(sh, "gather",
                            lambda *a: pytest.fail("a whole gather"))
        block = tp.BlockSource.block

        def keyed(src, path, index=None):
            self.key = (path, index)
            self.blocks[self.key] = self.blocks.get(self.key, 0) + 1
            return block(src, path, index)
        monkeypatch.setattr(tp.BlockSource, "block", keyed)

    def __call__(self, leaf, region, position, device, dtype, block=None,
                 prefer=(), grad=None):
        assert grad is not None       # the train step's gathers have a way back
        out = self.real(leaf, region, position, device, dtype, block=block,
                        prefer=prefer, grad=grad)
        if self.liveness and self.key[0][0] in tp.STACKED:
            alive = {k for r, k in self.live if r() is not None
                     and k[0] not in self.held}
            assert alive <= {self.key}, (alive, self.key)
        whole = leaf.shape[1:] if block is not None else leaf.shape
        if any("model" in tp._axes(e) for e in leaf.sharding.spec) and \
                region != (None,) * len(region):
            assert out.numel() < int(np.prod(whole))
        if all(out.data_ptr() != s.data_ptr() for s in leaf.shards):
            self.live.append((weakref.ref(out), self.key))
        return out


def _check(cfg, one, shape, preset, monkeypatch):
    loss1, aux1, g1 = one
    mesh, rules = _mesh(shape), rule_preset(preset)
    params = api.init_params(cfg, 0, mesh, rules)
    watch = _Watch(monkeypatch, cfg)
    with f32_unembed():
        (loss, aux), g = api.make_value_and_grad(cfg, mesh, rules)(
            params, _batch(cfg))
    monkeypatch.undo()
    assert abs(float(loss) - float(loss1)) <= TOL
    assert set(aux) == set(aux1)
    for k in aux1:
        assert abs(float(aux[k]) - float(aux1[k])) <= TOL, k
    assert all(isinstance(x, sh.Sharded) for x in optim.tree_leaves(g))
    for a, b in zip(optim.tree_leaves(g), optim.tree_leaves(g1)):
        assert a.shape == tuple(b.shape)
        assert all(tuple(s.shape) == a.sharding.shard_shape(a.shape)
                   for s in a.shards)
        whole = sh.gather_tree(a, CPU)
        assert torch.allclose(whole, b, atol=TOL, rtol=0), \
            float((whole - b).abs().max())
    assert all(r() is None for r, _ in watch.live)
    return watch


CASES = [(arch, shape) for arch in registry.list_archs() for shape in MESHES]


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in CASES])
def test_tp_training_matches_one_device(one_device, monkeypatch, arch,
                                        shape):
    """Full remat: the loss, its aux and every gradient leaf within 1e-5
    of one device; every block's slices gathered in the forward and again
    in the backward, none whole, each dropped after its block."""
    cfg = _f32(arch)
    assert cfg.remat == "full"
    watch = _check(cfg, one_device(cfg), shape, "baseline", monkeypatch)
    stacked = {k: n for k, n in watch.blocks.items() if k[1] is not None}
    # each row's group gathers each block twice
    assert stacked and set(stacked.values()) == {2 * shape[0]}, stacked


@pytest.mark.parametrize("remat", ["dots", "none"])
def test_tp_training_under_other_remat_policies(one_device, monkeypatch,
                                                remat):
    """"dots" saves each rank's own products, "none" recomputes nothing
    (each block gathered once): the gradients are the same."""
    cfg = _f32("h2o-danube-1.8b", remat=remat)
    for shape in MESHES:
        watch = _check(cfg, one_device(cfg), shape, "baseline", monkeypatch)
        counts = {n for k, n in watch.blocks.items() if k[1] is not None}
        assert counts == {shape[0] * (1 if remat == "none" else 2)}


def test_whisper_tinydp_groups_of_one(one_device, monkeypatch):
    """whisper under ``tinydp``: the batch over both axes, each row its own
    group of one, every leaf gathered whole along both axes block by
    block."""
    cfg = _f32("whisper-base")
    _check(cfg, one_device(cfg), (2, 2), "tinydp", monkeypatch)


def test_moe_load_balance_term_once_per_row(one_device):
    """olmoe: the load-balance term's partial sums are kept once per
    (layer, row), from the first rank of the row's group, and its loss
    and router gradients equal one device's on (1, 4) and (2, 2)."""
    cfg = _f32("olmoe-1b-7b")
    loss1, aux1, g1 = one_device(cfg)
    for shape in MESHES:
        mesh, rules = _mesh(shape), rule_preset("baseline")
        finished = []
        real = sh.RowContext.finish

        def finish(self, layer, row, counts, stats):
            finished.append((layer, row))
            return real(self, layer, row, counts, stats)
        sh.RowContext.finish = finish
        try:
            with f32_unembed():
                (loss, aux), g = api.make_value_and_grad(cfg, mesh, rules)(
                    api.init_params(cfg, 0, mesh, rules), _batch(cfg))
        finally:
            sh.RowContext.finish = real
        rows = len(tp.groups(mesh, rules, B))
        assert len(finished) == len(set(finished)) == cfg.n_layers * rows
        assert abs(float(aux["moe_aux_loss"]) - float(aux1["moe_aux_loss"])) \
            <= TOL
        router = sh.gather(g["blocks"]["sub0"]["moe"]["router"], CPU)
        want = g1["blocks"]["sub0"]["moe"]["router"]
        assert float(want.abs().max()) > 0
        assert torch.allclose(router, want, atol=TOL, rtol=0)


# ------------------------------------------------------- vocab-parallel CE
def _ce_inputs(v, d=8, b=2, s=12, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, s, d), generator=g, dtype=dtype)
    table = torch.randn((v, d), generator=g, dtype=dtype)
    toks = torch.randint(0, v, (b, s), generator=g)
    return x, table, toks


def _ce_tp(group, x, table, toks, sp):
    """The CE on ``group`` from whole inputs: each rank its vocab rows
    (whole when they do not divide), its sequence slice under ``sp``."""
    n, v = group.size, table.shape[0]
    rows = v // n if v % n == 0 else v
    tables = [table[r * rows:(r + 1) * rows] if rows < v else table
              for r in range(n)]
    s = x.shape[1]
    xs = [x[:, r * s // n:(r + 1) * s // n] if sp else x for r in range(n)]
    labels = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])], 1)
    return lm.chunked_cross_entropy_tp(group, xs, tables, labels, s - 1, v,
                                       sp, seq_chunk=8)


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("v", [16, 18])
def test_vocab_parallel_ce_matches_chunked_ce(v, sp):
    """Labels on each rank's first and last vocab row; a vocab that four
    ranks do not divide (each rank the whole CE); the stream whole or split
    along the sequence. The CE and its gradients against
    ``lm.chunked_cross_entropy`` on the shifted tokens."""
    group = coll.Group([CPU] * 4)
    x, table, toks = _ce_inputs(v)
    rows = v // 4
    toks[0, 1:9] = torch.tensor([0, rows - 1, rows, 2 * rows - 1, 2 * rows,
                                 3 * rows - 1, 3 * rows, v - 1])
    with f32_unembed():
        xa, ta = x.clone().requires_grad_(), table.clone().requires_grad_()
        want = lm.chunked_cross_entropy(xa[:, :-1], ta, toks[:, 1:])
        gx, gt = torch.autograd.grad(want, (xa, ta))
        xb, tb = x.clone().requires_grad_(), table.clone().requires_grad_()
        with torch.enable_grad():
            got = _ce_tp(group, xb, tb, toks, sp)
        hx, ht = torch.autograd.grad(got, (xb, tb))
    assert abs(float(got.detach()) - float(want.detach())) <= TOL
    assert torch.allclose(hx, gx, atol=TOL, rtol=0)
    assert torch.allclose(ht, gt, atol=TOL, rtol=0)


def _unembed_f64(params, x):
    return x @ params["table"].t()


def test_vocab_parallel_ce_gradcheck():
    """gradcheck in f64 of the CE on two ranks, the stream split along the
    sequence: the gathers, the logsumexp's combine and the gold logit's
    sum have their exact backward."""
    group = coll.Group([CPU] * 2)
    x, table, toks = _ce_inputs(6, d=3, b=1, s=4, dtype=torch.float64)
    saved, layers.unembed = layers.unembed, _unembed_f64
    try:
        assert torch.autograd.gradcheck(
            lambda a, t: _ce_tp(group, a, t, toks, True),
            (x.requires_grad_(), table.requires_grad_()))
    finally:
        layers.unembed = saved


class _Through(torch.autograd.Function):
    """A whole leaf ``w`` -> the regions that ``reads`` (position, region,
    prefer) gather from its shards; the backward is the gathers' own,
    into gradient buffers, assembled from each slice's first holder."""

    @staticmethod
    def forward(ctx, w, sharding, reads):
        shards = [w.detach()[idx].clone().requires_grad_()
                  for idx in sharding.indices(tuple(w.shape))]
        leaf = sh.Sharded(sharding, w.shape, shards)
        bufs = sh.Sharded(sharding, w.shape, [torch.zeros_like(s)
                                              for s in shards])
        with torch.enable_grad():
            outs = [sh.gather_region(leaf, region, p, CPU, w.dtype,
                                     prefer=prefer, grad=bufs)
                    for p, region, prefer in reads]
        ctx.outs, ctx.bufs = outs, bufs
        return tuple(o.detach().clone() for o in outs)

    @staticmethod
    def backward(ctx, *gs):
        for b in ctx.bufs.shards:
            b.zero_()
        torch.autograd.backward(ctx.outs, gs, retain_graph=True)
        return sh.gather(ctx.bufs, CPU), None, None


def test_gather_backward_gradcheck_and_tally():
    """gradcheck in f64 of ``gather_region``'s backward on a (2, 2) mesh
    (a leaf split over 'data' and 'model', and one copied along 'model'):
    the regions two ranks read, their own shard's view among them; every
    copy of a slice gets the same gradient; the tally records the
    reduce-scatter as the all-gather."""
    mesh = _mesh((2, 2))
    reads = [(0, ([(0, 3)], None), (0, 2)), (1, ([(3, 6)], None), (1, 3)),
             (0, (None, [(0, 2)]), (0, 2)), (3, ([(3, 6)], [(2, 4)]), ())]
    for spec in (PartitionSpec("model", "data"), PartitionSpec(None,
                                                               "data")):
        sharding = NamedSharding(mesh, spec)
        w = torch.randn((6, 4), dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(
            lambda a: _Through.apply(a, sharding, reads), (w,))
    shards = [w.detach()[i].clone().requires_grad_()
              for i in sharding.indices((6, 4))]
    leaf = sh.Sharded(sharding, (6, 4), shards)
    bufs = sh.Sharded(sharding, (6, 4), [torch.zeros_like(s)
                                         for s in shards])
    with coll.tally() as t, torch.enable_grad():
        out = sh.gather_region(leaf, (None, None), 0, CPU, w.dtype,
                               prefer=(0, 2), grad=bufs)
        out.sum().backward()
    assert t["all-gather"] == {0: 2 * 6 * 8}
    # its slice's gradient to the copy at 1, the other slice's to 2 and 3
    assert t["reduce-scatter"] == {0: 3 * 2 * 6 * 8}
    assert torch.equal(bufs.shards[0], bufs.shards[1])
    assert torch.equal(bufs.shards[2], bufs.shards[3])


# ----------------------------------------------------------------- plans
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen3-32b",
                                  "qwen2-vl-72b", "jamba-v0.1-52b"])
def test_train_plans_of_the_large_archs_fit_80gb(arch):
    """The train state on the production meshes' stand-ins, (16, 16) and
    (2, 16, 16): each position's shards, their cast and one block's slice
    with its gradient fit 80 GB, where the whole gathered copy did not."""
    cfg = registry.get_config(arch)
    tc = api.TrainConfig(**(dryrun.TRAIN_OVERRIDES.get((arch, "train_4k"))
                            or {}))
    whole = api.param_bytes(cfg, cfg.adtype)
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        terms = api.train_bytes(cfg, tc, mesh=mesh)
        need = api.train_state_bytes(cfg, tc, mesh=mesh)
        assert need == [sum(t) for t in zip(*terms.values())]
        assert max(need) < roofline.H100_SXM["hbm_bytes"]
        assert max(terms["block"]) < whole / cfg.n_layers
        api.check_fits(cfg, train_cfg=tc, mesh=mesh,
                       device_bytes=roofline.H100_SXM["hbm_bytes"])


def test_dry_run_train_cell_counts_one_rank():
    """Reduced danube's train cell on a (2, 2) stand-in counts one rank of
    one row's group: its arguments are its master, ``mu`` and ``nu``
    shards and its row of the batch; its state is the plan; its
    collectives are the tally of that count, which the real step on a CPU
    mesh tallies for the same position."""
    cfg = registry.reduced_config("h2o-danube-1.8b")
    stand = MeshShape(("data", "model"), (2, 2))
    cell = ShapeCell("t", 32, 4, "train")
    counted, meta = dryrun.build_and_count(cfg, cell, stand, DEFAULT_RULES)
    p = meta["position"]
    assert meta["rows"] == 2 and meta["row_batch"] == 2
    assert meta["state_bytes"] == api.train_state_bytes(
        cfg, mesh=stand)[p]
    shard = api.shard_param_bytes(cfg, stand)[p]
    assert counted["argument_bytes"] == 3 * shard + 2 * 32 * 4
    assert meta["coll"]["reduce-scatter"] > 0
    assert meta["coll"]["all-gather"] > 0 and meta["coll"]["all-reduce"] > 0
    assert meta["coll"] == api.step_collective_bytes(
        cfg, stand, DEFAULT_RULES, 4, seq=32)[p]


def test_whole_mesh_train_count_holds_every_position():
    """``dryrun.count_mesh_train`` (the card's check of a (2, 2) train
    step on one card): every position's master, ``mu`` and ``nu`` shards
    are its arguments, and its matrix FLOPs are the four ranks' own
    counts (two rows, each one rank's count twice)."""
    cfg = registry.reduced_config("h2o-danube-1.8b")
    cell = ShapeCell("t", 32, 4, "train")
    counted = dryrun.count_mesh_train(cfg, cell, (2, 2), DEFAULT_RULES)
    stand = MeshShape(("data", "model"), (2, 2))
    assert counted["argument_bytes"] == 3 * sum(
        api.shard_param_bytes(cfg, stand)) + 4 * 32 * 4
    one, _ = dryrun.build_and_count(cfg, cell, stand, DEFAULT_RULES)
    assert counted["flops"] == 4 * one["flops"]
