"""The tensor-parallel serving steps (``parallel/api`` on a mesh,
``parallel/tp.py``, ``parallel/collectives.py``, the models' ``*_tp``
functions) on the CPU repeated as (1, 4) and (2, 2) meshes.

Every reduced arch, under ``baseline`` (sequence-parallel prefill) and
``nosp`` (whisper: ``tinydp``, groups of one, and ``baseline``), in f32:
the prefill and teacher-forced decode logits within 1e-5 of the port's
one-device steps and the joined caches within 1e-5 (plus 1e-5 of their
size: the SSM states reach tens); no leaf gathered whole, each block's
slices dropped before the next block's are gathered. The KV heads fall
back whole at reduced size on four ranks (2 KV heads), and a config whose
query heads straddle their KV groups is served too. The collectives'
backward is each one's transpose (gradcheck); the counted matrix FLOPs of
one rank of qwen3-32b's published config on (1, 4) are a quarter of the
one-device step's; the memory plans serve jamba-v0.1-52b and
qwen2-vl-72b on 80 GB stand-ins. (The JAX package's sharded serving
steps are the oracle in ``tests/test_torch_lm_shard_numerics.py``.)
"""
import dataclasses
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.common.partitioning import rule_preset
from repro_torch.configs import registry
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import Mesh, MeshShape
from repro_torch.parallel import api, collectives as coll, sharded as sh, tp
from repro_torch.train import optim
from tests.torch_lm_f32 import f32_unembed
from tests.torch_lm_parity import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = 1e-5
B, S, DECODE = 4, 16, 4
MESHES = ((1, 4), (2, 2))


def _mesh(shape):
    return Mesh(np.array([CPU] * 4, dtype=object).reshape(shape),
                ("data", "model"))


def _inputs(cfg):
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + DECODE)))
    batch = {"tokens": toks[:, :S]}
    if cfg.is_encdec:
        batch["enc_embeddings"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "vision":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
        pos[1] //= 2
        pos[2] %= 4
        batch = {"embeddings": torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)),
            "positions": torch.from_numpy(pos)}
    return batch, [toks[:, S + i:S + i + 1] for i in range(DECODE)]


def _serve(cfg, params, mesh=None, rules=None):
    """(logits of the prefill and each decode step, the cache)."""
    enc = S if cfg.is_encdec else 0
    cap = S + DECODE
    batch, steps = _inputs(cfg)
    pre, info = api.make_prefill_step(cfg, mesh, rules, capacity=cap,
                                      batch_size=B, enc_len=enc)
    dec, _ = api.make_decode_step(cfg, mesh, rules, capacity=cap,
                                  batch_size=B, enc_len=enc)
    cache = (api.make_cache(cfg, B, cap, enc, device="cpu") if mesh is None
             else api.make_cache(cfg, B, cap, enc, shardings=info["cache"],
                                 rules=rules))
    with f32_unembed():
        out = [pre(params, batch, cache)[0]]
        for i, t in enumerate(steps):
            out.append(dec(params, cache, t, S + i)[0])
    return out, cache


class _BlockWatch:
    """``tp.gather_region`` wrapped: every slice a rank gets is no whole
    'model'-sharded leaf, and the copied slices alive at a gather are the
    current block's only."""

    def __init__(self, monkeypatch):
        self.live, self.calls, self.key = [], 0, None
        self.real = tp.gather_region
        monkeypatch.setattr(tp, "gather_region", self)
        monkeypatch.setattr(sh, "gather",
                            lambda *a: pytest.fail("a whole gather"))
        block = tp.BlockSource.block

        def keyed(src, path, index=None):
            self.key = (path, index)
            return block(src, path, index)
        monkeypatch.setattr(tp.BlockSource, "block", keyed)

    def __call__(self, leaf, region, position, device, dtype, block=None,
                 prefer=(), grad=None):
        out = self.real(leaf, region, position, device, dtype, block=block,
                        prefer=prefer, grad=grad)
        key = self.key
        alive = {k for r, k in self.live if r() is not None}
        assert alive <= {key}, (alive, key)
        whole = leaf.shape[1:] if block is not None else leaf.shape
        if any("model" in tp._axes(e) for e in leaf.sharding.spec) and \
                region != (None,) * len(region):
            assert out.numel() < int(np.prod(whole))
        if all(out.data_ptr() != s.data_ptr() for s in leaf.shards):
            self.live.append((weakref.ref(out), key))
        self.calls += 1
        return out


def _presets(cfg):
    return ("tinydp", "baseline") if cfg.is_encdec else ("baseline", "nosp")


CASES = [(arch, shape, preset) for arch in registry.list_archs()
         for shape in MESHES
         for preset in _presets(registry.reduced_config(arch))]


@pytest.fixture(scope="module")
def one_device():
    """Each arch's f32 params and its one-device logits and cache."""
    out = {}

    def get(arch):
        if arch not in out:
            cfg = dataclasses.replace(registry.reduced_config(arch),
                                      act_dtype="float32")
            params = api.init_params(cfg, 0, device="cpu")
            out[arch] = (cfg, params, *_serve(cfg, params))
        return out[arch]
    return get


@pytest.mark.parametrize("arch,shape,preset", CASES, ids=[
    f"{a}-{s[0]}x{s[1]}-{p}" for a, s, p in CASES])
def test_tp_serving_matches_one_device(one_device, monkeypatch, arch, shape,
                                       preset):
    cfg, params, want, one = one_device(arch)
    mesh, rules = _mesh(shape), rule_preset(preset)
    sparams = api.init_params(cfg, 0, mesh, rules)
    watch = _BlockWatch(monkeypatch)
    with coll.tally() as moved:
        got, cache = _serve(cfg, sparams, mesh, rules)
    assert watch.calls and all(r() is None for r, _ in watch.live)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.allclose(a, b, atol=TOL, rtol=0), (
            i, float((a - b).abs().max()))
    for a, b in zip(optim.tree_leaves(cache.gather(CPU)),
                    optim.tree_leaves(one)):
        assert a.shape == b.shape
        assert torch.allclose(a.float(), b.float(), atol=TOL, rtol=TOL)
    size = 1 if preset == "tinydp" else shape[1]
    assert [len(g.positions) for g in cache.groups] == \
        [size] * (4 // size if preset == "tinydp" else shape[0])
    if size > 1:
        # the prompt divides: baseline scatters the sums along the
        # sequence, nosp all-reduces them
        assert bool(moved.get("reduce-scatter")) == (preset == "baseline")
        assert moved.get("all-reduce")
    else:
        assert not moved.get("reduce-scatter") and not moved.get(
            "all-reduce")


def test_query_heads_straddling_their_kv_groups(monkeypatch):
    """Six query heads over three KV heads on two ranks: each rank's three
    query heads read KV heads (0, 0, 1) and (1, 2, 2), which fall back
    whole (three do not split two ways); the steps still equal one
    device's."""
    cfg = dataclasses.replace(registry.reduced_config("yi-6b"),
                              act_dtype="float32", n_heads=6, n_kv_heads=3,
                              head_dim=16)
    from repro_torch.models import attention
    assert attention.kv_select(cfg, 3, 3, 0) == [0, 0, 1]
    assert attention.kv_select(cfg, 3, 3, 1) == [1, 2, 2]
    assert attention.kv_select(cfg, 6, 3, 0) is None
    small = registry.reduced_config("yi-6b")      # 4 heads over 2 on 4
    assert [attention.kv_select(small, 1, 2, r) for r in range(4)] == [
        slice(0, 1), slice(0, 1), slice(1, 2), slice(1, 2)]
    params = api.init_params(cfg, 0, device="cpu")
    want, _ = _serve(cfg, params)
    mesh = Mesh([[CPU, CPU]], ("data", "model"))
    rules = rule_preset("baseline")
    got, cache = _serve(cfg, api.init_params(cfg, 0, mesh, rules), mesh,
                        rules)
    assert cache.split["kv"] is False
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=TOL, rtol=0)


# ------------------------------------------------------------ collectives
def _group(n=3):
    return coll.Group([CPU] * n)


def _xs(shape, n=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(n)]


@pytest.mark.parametrize("name", ["all_gather", "all_reduce",
                                  "reduce_scatter"])
def test_collective_backward_is_its_transpose(name):
    """gradcheck of each collective's autograd Function: all-gather and
    reduce-scatter are each other's backward, all-reduce its own."""
    group = _group()
    fn = {"all_gather": lambda *x: coll.all_gather(group, x, 1),
          "all_reduce": lambda *x: coll.all_reduce(group, x),
          "reduce_scatter": lambda *x: coll.reduce_scatter(group, x, 1)}
    xs = _xs((2, 6, 3))
    assert torch.autograd.gradcheck(lambda *x: tuple(fn[name](*x)), xs)


def test_collectives_sum_in_rank_order_on_every_rank():
    """Each rank's sum is the rank-order sum, bit for bit on every rank;
    the tally counts what each rank receives; a count of one rank stands
    in for the others on meta tensors only."""
    group = _group(4)
    xs = [x.detach().float() for x in _xs((2, 8, 5), 4, seed=1)]
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    with coll.tally() as t:
        red = coll.all_reduce(group, xs)
        sc = coll.reduce_scatter(group, xs, 1)
        ga = coll.all_gather(group, xs, 1)
    assert all(torch.equal(r, want) for r in red)
    assert all(torch.equal(s, want[:, 2 * r:2 * r + 2])
               for r, s in enumerate(sc))
    assert all(torch.equal(g, torch.cat(xs, 1)) for g in ga)
    nbytes = xs[0].numel() * 4
    assert t["all-reduce"] == t["all-gather"] == dict.fromkeys(
        range(4), 3 * nbytes)
    assert t["reduce-scatter"] == dict.fromkeys(range(4), 3 * nbytes // 4)
    assert t["spans"]["all-gather"] == {(0, 1, 2, 3)}
    one = coll.Group([torch.device("meta")] * 4, ranks=[2])
    meta = [torch.empty((2, 8, 5), device="meta")]
    assert coll.all_gather(one, meta, 1)[0].shape == (2, 32, 5)
    with pytest.raises(ValueError, match="meta"):
        coll.all_reduce(one, [xs[0]])


# ------------------------------------------------------------- the split
@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_one_rank_counts_a_quarter_of_the_products(step):
    """qwen3-32b's published config on a (1, 4) stand-in, on meta tensors
    (``roofline.Counter``): one rank's matrix FLOPs are a quarter of the
    one-device step's (heads, KV heads, ``mlp`` and vocab all divide by
    4); its arguments are its own shards and cache; its live bytes never
    reach one whole block (its 'model' slices are views of its shards)."""
    cfg = registry.get_config("qwen3-32b")
    b, s = 1, 64
    mesh = MeshShape(("data", "model"), (1, 4))
    rules = rule_preset("baseline")
    inputs = api._meta_inputs(cfg, step, b, s, 0)
    params, _ = api.abstract_params(cfg, compute_dtype=cfg.adtype)
    cache = api.abstract_cache(cfg, b, s, 0)
    if step == "prefill":
        one, _ = api.make_prefill_step(cfg, capacity=s, batch_size=b)
        args = (params, inputs, cache)
    else:
        one, _ = api.make_decode_step(cfg, capacity=s, batch_size=b)
        args = (params, cache, inputs["tokens"], s - 1)
    with roofline.Counter(args[:3]) as whole:
        one(*args)
    run, state = api.meta_serving_step(cfg, mesh, rules, step, inputs, 1,
                                       s, 0, 2)
    with roofline.Counter((state, inputs)) as rank:
        run()
    assert rank.result()["flops"] * 4 == whole.result()["flops"]
    shards = api.shard_param_bytes(cfg, mesh, rules, cfg.adtype)[2]
    plan = api.serving_bytes(cfg, mesh, rules, cfg.adtype, (b, s, 0))
    assert plan["block"][2] == 0
    assert rank.argument_bytes == shards + plan["cache"][2] + sum(
        t.numel() * t.element_size() for t in inputs.values())
    block = api.param_bytes(cfg, cfg.adtype) / cfg.n_layers
    assert rank.result()["temp_bytes"] < block


# ----------------------------------------------------------------- plans
@pytest.mark.parametrize("arch,shards_gb", [("jamba-v0.1-52b", 25.7),
                                            ("qwen2-vl-72b", 36.4)])
def test_plans_serve_the_large_archs_on_80gb_stand_ins(arch, shards_gb):
    """bf16 serving on four 80 GB positions: the shards and the largest
    block's copied slices fit, where the whole gathered copy (102.9 and
    145.4 GB) did not."""
    cfg = registry.get_config(arch)
    whole = api.param_bytes(cfg, cfg.adtype)
    for shape in ((2, 2), (4, 1)):
        stand = SimpleNamespace(shape={"data": shape[0], "model": shape[1]})
        parts = api.serving_bytes(cfg, stand, rule_preset("baseline"),
                                  cfg.adtype)
        assert max(parts["shards"]) / 1e9 == pytest.approx(shards_gb,
                                                           abs=0.05)
        assert max(parts["block"]) < whole / 8
        api.check_fits(cfg, compute_dtype=cfg.adtype, mesh=stand,
                       device_bytes=roofline.H100_SXM["hbm_bytes"])
        assert api.param_bytes(cfg, cfg.adtype, mesh=stand) == [
            a + b for a, b in zip(parts["shards"], parts["block"])]
        cache = api.serving_bytes(cfg, stand, rule_preset("baseline"),
                                  cfg.adtype, (4, 4096, 0))["cache"]
        assert min(cache) > 0


def test_dry_run_serving_cell_counts_one_rank():
    """A serving cell on a stand-in mesh counts one rank of one row's
    group: its arguments are its shards, its cache and its row's tokens,
    its collectives the tally of that count (the sums over the group and
    the block-wise gathers over 'data')."""
    cfg = registry.reduced_config("yi-6b")
    mesh = MeshShape(("data", "model"), (2, 2))
    from repro_torch.configs.shapes import ShapeCell
    cell = ShapeCell("d", 32, 4, "decode")
    counted, meta = dryrun.build_and_count(cfg, cell, mesh,
                                           rule_preset("baseline"))
    p = meta["position"]
    plan = api.serving_bytes(cfg, mesh, rule_preset("baseline"), cfg.adtype,
                             (4, 32, 0))
    assert meta["rows"] == 2 and meta["row_batch"] == 2
    assert counted["argument_bytes"] == plan["shards"][p] + \
        plan["cache"][p] + 2 * 4
    assert meta["state_bytes"] == plan["shards"][p] + plan["block"][p]
    assert meta["coll"]["all-reduce"] > 0 and meta["coll"]["all-gather"] > 0
    assert meta["coll"] == api.step_collective_bytes(
        cfg, mesh, rule_preset("baseline"), 4, train=False, step="decode",
        capacity=32)[p]
