"""The tensor-parallel serving steps (``parallel/api`` on a mesh,
``parallel/tp.py``, ``parallel/collectives.py``, the models' ``*_tp``
functions) on the CPU repeated as (1, 4) and (2, 2) meshes.

Every reduced arch, under ``baseline`` (sequence-parallel prefill) and
``nosp`` (whisper: ``tinydp``, groups of one, and ``baseline``), in f32:
the prefill and teacher-forced decode logits within 1e-5 of the port's
one-device steps and the joined caches within 1e-5 (plus 1e-5 of their
size: the SSM states reach tens); each rank's cache leaf the shard that
``cache_specs`` gives its position (under ``baseline`` a chunk of the
positions for every KV head, decoded as a split softmax; under ``nosp``
the KV heads where they divide), also where the cache length does not
divide the group, for a ring cache and with empty chunks; no leaf
gathered whole, each block's slices dropped before the next block's are
gathered. A config whose query heads straddle their KV groups is served
too. The collectives'
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

from repro_torch.common.partitioning import LogicalRules, NamedSharding, \
    rule_preset
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


def _inputs(cfg, s=S, decode=DECODE, enc=None):
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, s + decode)))
    batch = {"tokens": toks[:, :s]}
    if cfg.is_encdec:
        batch["enc_embeddings"] = torch.from_numpy(rng.standard_normal(
            (B, enc or s, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "vision":
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, B, s)).copy()
        pos[1] //= 2
        pos[2] %= 4
        batch = {"embeddings": torch.from_numpy(rng.standard_normal(
            (B, s, cfg.d_model)).astype(np.float32)),
            "positions": torch.from_numpy(pos)}
    return batch, [toks[:, s + i:s + i + 1] for i in range(decode)]


def _serve(cfg, params, mesh=None, rules=None, s=S, decode=DECODE,
           enc=None):
    """(logits of the prefill and each decode step, the cache): a prompt
    of ``s`` tokens (whisper: ``enc`` encoder frames, ``s`` by default),
    then ``decode`` steps, in a cache of ``s + decode``."""
    enc = (enc or s) if cfg.is_encdec else 0
    cap = s + decode
    batch, steps = _inputs(cfg, s, decode, enc)
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
            out.append(dec(params, cache, t, s + i)[0])
    return out, cache


def _assert_shards(cfg, mesh, rules, cache, one, cap, enc):
    """Each rank's KV, slot-position and cross-attention leaf is the shard
    ``cache_specs`` gives its mesh position: its shape and the one-device
    cache's values at the shard's indices. Returns the layouts seen."""
    shapes, specs = api.cache_specs(cfg, mesh, LogicalRules(rules.rules), B,
                                    cap, enc)
    seen = set()
    for group, ranks in zip(cache.groups, cache.rows):
        for p, tree in zip(group.positions, ranks):
            for path, leaf in tp.walk(tree):
                if path[-1] in ("ssm_state", "conv_state"):
                    continue
                want, spec, shape = one, specs, shapes
                for k in path:
                    want, spec, shape = want[k], spec[k], shape[k]
                sharding = NamedSharding(mesh, spec)
                assert tuple(leaf.shape) == sharding.shard_shape(
                    shape.shape), (p, path, spec)
                want = want[sharding.indices(shape.shape)[p]]
                assert torch.allclose(leaf.float(), want.float(), atol=TOL,
                                      rtol=TOL), (p, path)
                seen.add((path[0], path[-1], _layout(cache, path)))
    return seen


def _layout(cache, path):
    node = cache.layout
    for k in path:
        node = node[k]
    return node


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
    enc = S if cfg.is_encdec else 0
    seen = _assert_shards(cfg, mesh, rules, cache, one, S + DECODE, enc)
    # the cache length (20) divides every group: baseline splits the
    # sequence, nosp the KV heads where they divide (olmoe: 4), tinydp
    # (groups of one) nothing
    want = {"baseline": 2, "tinydp": None}.get(
        preset, 3 if cfg.n_kv_heads % shape[1] == 0 else None)
    kv = {lay for _, name, lay in seen if name == "k"}
    assert kv == {want} or (not kv and arch == "mamba2-2.7b")
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
    device's, with the cache split along the sequence (``baseline``: the
    prefill attends each rank's selection) and whole (``nosp``: decode
    too)."""
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
    for preset, layout in (("baseline", 2), ("nosp", None)):
        rules = rule_preset(preset)
        got, cache = _serve(cfg, api.init_params(cfg, 0, mesh, rules), mesh,
                            rules)
        assert cache.layout["sub0"]["k"] == layout
        for a, b in zip(got, want):
            assert torch.allclose(a, b, atol=TOL, rtol=0)


# (arch, mesh, preset, prompt, decode steps, encoder frames, the k
# layouts): a cache of 21 does not divide 4 (2 KV heads neither: whole)
# or 2 (the heads split); danube's ring of 16 slots under an 18-token
# prompt (rolled by 2), split along its slots or its heads; a 3-token
# prompt in a cache of 8 on 4 ranks (two slots a rank: ranks 2 and 3
# hold nothing at the first decode step, rank 2's first slot comes at the
# third); qwen2-vl's M-RoPE the same way; whisper's cross cache of 18
# encoder frames (heads) beside a self cache of 20 (sequence).
LAYOUT_CASES = [
    ("yi-6b", (1, 4), "baseline", 16, 5, None, {None}),
    ("yi-6b", (2, 2), "baseline", 16, 5, None, {3}),
    ("h2o-danube-1.8b", (1, 4), "baseline", 18, 4, None, {2}),
    ("h2o-danube-1.8b", (2, 2), "nosp", 18, 4, None, {3}),
    ("yi-6b", (1, 4), "baseline", 3, 5, None, {2}),
    ("qwen2-vl-72b", (1, 4), "baseline", 3, 5, None, {2}),
    ("whisper-base", (1, 4), "baseline", 16, 4, 18, {2, 3}),
]


@pytest.mark.parametrize("arch,shape,preset,s,decode,enc,kv", LAYOUT_CASES,
                         ids=[f"{c[0]}-{c[1][0]}x{c[1][1]}-{c[2]}-{c[3]}+"
                              f"{c[4]}" for c in LAYOUT_CASES])
def test_tp_serving_cache_layouts(arch, shape, preset, s, decode, enc, kv):
    """The cache's fallbacks, a ring cache and empty chunks: logits and the
    gathered cache within 1e-5 of one device, each rank's leaves the
    shards ``cache_specs`` gives its position, the layouts as stated."""
    cfg = dataclasses.replace(registry.reduced_config(arch),
                              act_dtype="float32")
    params = api.init_params(cfg, 0, device="cpu")
    want, one = _serve(cfg, params, s=s, decode=decode, enc=enc)
    mesh, rules = _mesh(shape), rule_preset(preset)
    got, cache = _serve(cfg, api.init_params(cfg, 0, mesh, rules), mesh,
                        rules, s=s, decode=decode, enc=enc)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all()
        assert torch.allclose(a, b, atol=TOL, rtol=0), (
            i, float((a - b).abs().max()))
    for a, b in zip(optim.tree_leaves(cache.gather(CPU)),
                    optim.tree_leaves(one)):
        assert torch.allclose(a.float(), b.float(), atol=TOL, rtol=TOL)
    seen = _assert_shards(cfg, mesh, rules, cache, one, s + decode,
                          (enc or s) if cfg.is_encdec else 0)
    assert {lay for _, name, lay in seen if name == "k"} == kv
    if cfg.swa_window:      # a ring of the window's slots
        assert cache.gather(CPU)["sub0"]["slot_pos"].shape[-1] == \
            cfg.swa_window < s + decode


# ---------------------------------------------------- the split softmax
def test_combined_partials_equal_one_softmax():
    """Four ranks' chunks (two of them masked entirely, one partly): their
    statistics combined and their terms summed equal one softmax over the
    concatenated keys within 1e-6, with no NaN; a chunk masked entirely
    gives (NEG_INF, 0) and a zero term, and leaving it out changes
    nothing."""
    from repro_torch.models import attention
    g = torch.Generator().manual_seed(0)
    b, h, kv, hd, n = 2, 8, 2, 16, 5
    q = torch.randn((b, 1, h, hd), generator=g)
    ks = [torch.randn((b, n, kv, hd), generator=g) * 3 for _ in range(4)]
    vs = [torch.randn((b, n, kv, hd), generator=g) for _ in range(4)]
    valid = [torch.tensor([True, True, False, True, True]),
             torch.zeros(n, dtype=torch.bool),
             torch.tensor([False, True, False, False, False]),
             torch.zeros(n, dtype=torch.bool)]

    def split(ranks):
        scored = [attention.chunk_scores(q, ks[r], valid[r]) for r in ranks]
        top, den = attention.combine_stats(torch.stack([st for _, st in
                                                        scored]))
        terms = [attention.chunk_output(s, valid[r], top, den, vs[r],
                                        q.dtype)
                 for r, (s, _) in zip(ranks, scored)]
        return scored, terms, attention._rank_sum(torch.stack(terms))

    scored, terms, got = split(range(4))
    assert bool((scored[1][1][..., 0] == attention.NEG_INF).all())
    assert bool((scored[1][1][..., 1] == 0).all())
    assert torch.equal(terms[1], torch.zeros((b, h, hd)))
    mask = torch.cat(valid)
    want = attention._grouped_attend(q, torch.cat(ks, 1), torch.cat(vs, 1),
                                     mask[None, None])[:, 0]
    assert torch.isfinite(got).all()
    assert torch.allclose(got, want, atol=1e-6, rtol=0), float(
        (got - want).abs().max())
    assert torch.allclose(got, split([0, 2])[2], atol=1e-7, rtol=0)


# ------------------------------------------------------------ collectives
def _group(n=3):
    return coll.Group([CPU] * n)


def _xs(shape, n=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(n)]


@pytest.mark.parametrize("name", ["all_gather", "all_reduce",
                                  "reduce_scatter", "all_to_all"])
def test_collective_backward_is_its_transpose(name):
    """gradcheck of each collective's autograd Function: all-gather and
    reduce-scatter are each other's backward, all-reduce its own,
    all-to-all its own with the two dims swapped."""
    group = _group()
    fn = {"all_gather": lambda *x: coll.all_gather(group, x, 1),
          "all_reduce": lambda *x: coll.all_reduce(group, x),
          "reduce_scatter": lambda *x: coll.reduce_scatter(group, x, 1),
          "all_to_all": lambda *x: coll.all_to_all(group, x, 1, 2)}
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
    with coll.tally() as t:
        ex = coll.all_to_all(group, xs, 1, 0)
    assert all(torch.equal(e, torch.cat([x[:, 2 * r:2 * r + 2] for x in xs]))
               for r, e in enumerate(ex))
    assert t["all-to-all"] == dict.fromkeys(range(4), 3 * nbytes // 4)
    one = coll.Group([torch.device("meta")] * 4, ranks=[2])
    meta = [torch.empty((2, 8, 5), device="meta")]
    assert coll.all_gather(one, meta, 1)[0].shape == (2, 32, 5)
    assert coll.all_to_all(one, meta, 1, 0)[0].shape == (8, 2, 5)
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


# ------------------------------------------------------- the cache plan
def _shard_bytes(cfg, mesh, rules, batch, cap, enc):
    """Each position's bytes of ``cache_specs``' shards (JAX's layout),
    with the conv state as the port holds it (its rank's x columns and
    the whole B and C: the stated difference)."""
    shapes, specs = api.cache_specs(cfg, mesh, LogicalRules(rules.rules),
                                    batch, cap, enc)
    size = mesh.shape["model"]
    out = [0] * (mesh.shape["data"] * size)
    for path, leaf in tp.walk(shapes):
        spec = specs
        for k in path:
            spec = spec[k]
        shard = list(NamedSharding(mesh, spec).shard_shape(leaf.shape))
        if path[-1] == "conv_state" and shard[-1] < leaf.shape[-1]:
            di = cfg.ssm.d_inner(cfg.d_model)
            shard[-1] = di // size + leaf.shape[-1] - di
        for p in range(len(out)):
            out[p] += int(np.prod(shard)) * leaf.element_size()
    return out


@pytest.mark.parametrize("arch", ["yi-6b", "h2o-danube-1.8b", "jamba-v0.1-52b",
                                  "whisper-base"])
def test_serving_bytes_cache_term_is_the_shards_of_cache_specs(arch):
    """``serving_bytes``' cache term at each position of a row's group is
    the sum of the bytes of the shards ``cache_specs`` gives it, on (1, 4)
    and (2, 2), at a length that divides the group and one that does not,
    under each preset its serving test uses."""
    cfg = registry.reduced_config(arch)
    for shape in MESHES:
        stand = SimpleNamespace(shape={"data": shape[0], "model": shape[1]})
        for preset in _presets(cfg):
            rules = rule_preset(preset)
            for cap in (20, 21):
                enc = cap if cfg.is_encdec else 0
                got = api.serving_bytes(cfg, stand, rules, cfg.adtype,
                                        (B, cap, enc))["cache"]
                want = _shard_bytes(cfg, stand, rules, B, cap, enc)
                for g in tp.groups(stand, rules, B):
                    for p in g:
                        assert got[p] == want[p], (shape, preset, cap, p)


def test_qwen2_vl_decode_32k_fits_on_16x16():
    """The dry run's qwen2-vl-72b decode_32k cell on (16, 16): the cache
    of a row (8 examples x 32,768 positions x 8 KV heads x 128 x 80
    layers, K and V, bf16: 85.9 GB) is split along its positions, 5.37 GB
    a device, and the cell fits 80 GB (it did not when the 8 KV heads,
    which do not split 16 ways, were each rank's whole)."""
    cfg = registry.get_config("qwen2-vl-72b")
    mesh = MeshShape(("data", "model"), (16, 16))
    rules = rule_preset("baseline")
    plan = api.serving_bytes(cfg, mesh, rules, cfg.adtype, (128, 32768, 0))
    row = 80 * 2 * 8 * 32768 * 8 * 128 * 2
    slots = 80 * 2048 * 4                   # each rank's slot positions
    assert max(plan["cache"]) == min(plan["cache"]) == row // 16 + slots
    rec = dryrun.lower_cell("qwen2-vl-72b", "decode_32k", False,
                            verbose=False)
    mem = rec["memory_analysis"]
    assert mem["fits_h100_80g"], mem
    assert mem["argument_bytes"] < 8e9
    assert rec["collectives"]["all-to-all"] > 0
