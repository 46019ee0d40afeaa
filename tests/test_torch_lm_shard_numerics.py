"""The LM sharding's numerics (``parallel/api`` on a mesh,
``parallel/sharded.py``, the MoE's row context) on ``Mesh([cpu] * 4)`` as
(2, 2), against the JAX package's sharded steps and the port's own
one-device steps.

The JAX side runs once, in a subprocess on eight forced host devices
(``tests/jax_lm_sharding_reference.py``: JAX fixes its device count when
it starts), on an Auto-axis (2, 2) mesh. The port's side repeats the CPU:
the same split, each row's work one after another.

Bars (f32, the unembedding widened to f32 on both sides as in
``tests/torch_lm_parity.py``): losses and grad norms within 1e-4 of the
JAX steps (``TOL``, the one-device parity bar) and within 1e-5 of the
port's one-device step; after the steps every param within 1e-5 of the
one-device step's; every gradient leaf within 1e-5 of the one-device
gradient and 1e-4 of ``jax.value_and_grad`` on JAX's mesh; logits of the sharded prefill and decode within 1e-5 of
the port's ``lm`` functions and 1e-4 of JAX's sharded steps; the clip's
norm within 1e-6 of the norm of the gathered gradients; replicated copies
and restored checkpoints bit for bit.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.common.partitioning import (ActivationSharder,
                                             rule_preset,
                                             specs_to_shardings)
from repro_torch.configs import registry as tregistry
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm as tlm, moe as tmoe
from repro_torch.parallel import api, sharded as sh
from repro_torch.train import optim
from tests import jax_lm_sharding_reference as R
from tests import torch_lm_parity as P
from tests.torch_lm_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SELF_TOL = 1e-5


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's sharded outputs (one subprocess, ~30 s)."""
    path = str(tmp_path_factory.mktemp("jax_lm_sharding") / "ref.npz")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, "-m", "tests.jax_lm_sharding_reference", path],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    with np.load(path) as z:
        return {"path": path, **{k: z[k] for k in z.files}}


def mesh22():
    return Mesh(np.array([CPU] * 4, dtype=object).reshape(2, 2),
                ("data", "model"))


def sharded_params(cfg, params, mesh, rules):
    """One-device params placed by ``param_specs``."""
    _, specs = api.param_specs(cfg, mesh, rules)
    return sh.shard_tree(params, specs_to_shardings(specs, mesh))


def run(cfg, params, mesh=None, rules=None, steps=R.STEPS, **tc):
    """(per-step metrics, final state) of ``make_train_step`` on the
    parity helper's batches (the steps update the params in place: they
    start from a copy)."""
    train_cfg = api.TrainConfig(**tc)
    params = optim.tree_map(torch.clone, params)
    if mesh is not None:
        params = sharded_params(cfg, params, mesh, rules)
    step, _ = api.make_train_step(cfg, mesh, rules, train_cfg=train_cfg)
    state = api.make_train_state(params,
                                 compression=train_cfg.compression is not None)
    rows = []
    with P.f32_unembed():
        for b in P.token_batches(cfg, steps=steps):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            rows.append({k: float(m[k]) for k in P.JAX_STEP_KEYS})
    return rows, state


def assert_rows_close(got, want, tol):
    """Each step's metrics (the keys of ``got``'s rows)."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in g:
            assert abs(g[k] - w[k]) <= tol * (1 + abs(w[k])), (i, k, g, w)


def assert_state_close(sharded_state, state, tol):
    for a, b in zip(optim.tree_leaves(sharded_state["params"]),
                    optim.tree_leaves(state["params"])):
        assert a.shape == tuple(b.shape)
        assert torch.allclose(sh.gather(a, CPU), b, atol=tol, rtol=0)


def jax_rows(ref, prefix):
    return [{k: float(ref[f"{prefix}/{k}"][i]) for k in P.JAX_STEP_KEYS}
            for i in range(R.STEPS)]


@pytest.mark.parametrize("arch", R.TRAIN_ARCHS)
def test_sharded_training_matches_jax_and_one_device(ref, arch):
    cfg, _, params = P.port_train_params(arch)
    one_rows, one = run(cfg, params)
    rows, state = run(cfg, params, mesh22(), rule_preset("baseline"))
    assert_rows_close(rows, jax_rows(ref, f"train/{arch}"), P.TOL)
    assert_rows_close(rows, one_rows, SELF_TOL)
    assert_state_close(state, one, SELF_TOL)
    assert rows[-1]["loss"] < rows[0]["loss"]


@pytest.mark.parametrize("arch", R.TRAIN_ARCHS + R.GRAD_ARCHS)
def test_sharded_gradients_match_leaf_for_leaf(ref, arch):
    """Every gradient leaf of the sharded (tensor-parallel) loss, gathered
    from its shards, against the port's one-device gradient and
    ``jax.value_and_grad`` on JAX's (2, 2) mesh, on the first batch: a
    leaf whose gradient is counted once per copy, the load-balance
    gradient to olmoe's router lost across the rows or ranks, or an SSM
    head's (mamba2, split by heads) shows here even where the global norm
    hides it."""
    cfg, _, params = P.port_train_params(arch)
    mesh, rules = mesh22(), rule_preset("baseline")
    batch = {k: torch.from_numpy(v)
             for k, v in P.token_batches(cfg, steps=1)[0].items()}
    with P.f32_unembed():
        (loss1, _), one = api.make_value_and_grad(cfg)(params, batch)
        (loss, _), got = api.make_value_and_grad(cfg, mesh, rules)(
            sharded_params(cfg, params, mesh, rules), batch)
    assert abs(float(loss) - float(loss1)) <= SELF_TOL
    P.assert_close(loss, ref[f"grad/{arch}/loss"], "loss")
    assert all(isinstance(g, sh.Sharded) for g in optim.tree_leaves(got))
    whole = sh.gather_tree(got, CPU)
    for a, b in zip(optim.tree_leaves(whole), optim.tree_leaves(one)):
        assert a.shape == b.shape
        assert torch.allclose(a, b, atol=SELF_TOL, rtol=0), \
            float((a - b).abs().max())
    P.assert_tree_close(whole, _unflat(ref, f"grad/{arch}"), path="grad")


def test_microbatched_step_matches_the_plain_step():
    """``num_microbatches=4`` (JAX's micro-batches, each split over the
    rows) against the one-device microbatched step, and its loss and grad
    norm against the plain sharded step's (its ``ce`` is the last
    micro-batch's, as in the JAX step)."""
    cfg, _, params = P.port_train_params("h2o-danube-1.8b")
    plain, _ = run(cfg, params, mesh22(), rule_preset("baseline"))
    one_mb, _ = run(cfg, params, num_microbatches=4)
    rows, _ = run(cfg, params, mesh22(), rule_preset("baseline"),
                  num_microbatches=4)
    assert_rows_close(rows, one_mb, SELF_TOL)
    assert_rows_close([{k: r[k] for k in ("loss", "grad_norm")}
                       for r in rows], plain, SELF_TOL)


def test_topk_compression_matches(ref):
    """Top-k with error feedback on the sharded gradients: the threshold
    of the whole leaf, against JAX's sharded step and the port's
    one-device one."""
    arch = R.TOPK_ARCH
    cfg, _, params = P.port_train_params(arch)
    one_rows, _ = run(cfg, params, compression="topk")
    rows, state = run(cfg, params, mesh22(), rule_preset("baseline"),
                      compression="topk")
    assert_rows_close(rows, jax_rows(ref, f"topk/{arch}"), P.TOL)
    assert_rows_close(rows, one_rows, SELF_TOL)
    assert all(isinstance(l, sh.Sharded)
               for l in optim.tree_leaves(state["efb"]))


def _serve_against(ref, arch):
    """``arch`` in f32: the sharded (tensor-parallel) prefill and ``DECODE``
    teacher-forced decode steps against ``lm.prefill``/``lm.decode_step``
    on one device and against JAX's sharded steps; the rows' caches joined
    equal the one-device cache. Returns (the cache, a copy of its ranks'
    leaves after the prefill)."""
    _, cfg = P.configs(arch)
    prefix = R.serve_prefix(arch)
    params = tlm.from_jax_params(_unflat(ref, prefix + "/params"), cfg,
                                 device="cpu")
    mesh, rules = mesh22(), rule_preset("baseline")
    inp = P.inputs(cfg)
    cap = P.S + P.DECODE
    pre, info = api.make_prefill_step(cfg, mesh, rules, capacity=cap,
                                      batch_size=P.B)
    dec, dinfo = api.make_decode_step(cfg, mesh, rules, capacity=cap,
                                      batch_size=P.B)
    assert tuple(dinfo["tok_sharding"].spec) == ("data", None)
    sparams = sharded_params(cfg, params, mesh, rules)
    cache = api.make_cache(cfg, P.B, cap, shardings=info["cache"])
    one = api.make_cache(cfg, P.B, cap, device="cpu")
    toks = torch.from_numpy(inp["tokens"])
    with P.f32_unembed():
        got, cache = pre(sparams, {"tokens": toks}, cache)
        prefilled = [[optim.tree_map(torch.clone, t) for t in row]
                     for row in cache.rows]
        want, one = tlm.prefill(params, cfg, {"tokens": toks}, one)
        outs = [(got, want)]
        for i in range(P.DECODE):
            t = torch.from_numpy(inp["decode"][:, i:i + 1])
            got, cache = dec(sparams, cache, t, P.S + i)
            want, one = tlm.decode_step(params, cfg, t, P.S + i, one)
            outs.append((got, want))
    for i, (got, want) in enumerate(outs):
        assert torch.allclose(got, want, atol=SELF_TOL, rtol=0), i
        np.testing.assert_allclose(got.numpy(), ref[prefix + "/logits"][i],
                                   atol=P.TOL, rtol=P.TOL)
    joined = cache.gather(CPU)
    for a, b in zip(optim.tree_leaves(joined), optim.tree_leaves(one)):
        assert torch.allclose(a.float(), b.float(), atol=SELF_TOL, rtol=0)
    return cache, prefilled


def test_sharded_prefill_and_decode(ref):
    """yi-6b (``R.SERVE_ARCH``) on (2, 2): two rows of two-rank groups,
    each rank's cache its row's half of the batch and, as JAX's
    ``cache_specs`` places it under ``baseline``, its half of the 24
    positions for both KV heads."""
    cache, _ = _serve_against(ref, R.SERVE_ARCH)
    assert len(cache.rows) == 2 and all(len(r) == 2 for r in cache.rows)
    assert cache.layout == {"sub0": {"k": 2, "v": 2, "slot_pos": 1}}
    assert cache.kv_seq == {"sub0": True}
    assert all(l.shape[1] == 1 and l.shape[2] == 12 and l.shape[3] == 2
               for rank in cache.rows[0] for l in optim.tree_leaves(rank)
               if l.ndim > 2)


@pytest.mark.parametrize("arch", R.SERVE_ARCHS[1:])
def test_tensor_parallel_serving_matches_jax(ref, arch):
    """The expert-parallel MoE (olmoe) and the SSM split by heads (mamba2)
    on (2, 2), against JAX's sharded steps and the port's one device."""
    cache, _ = _serve_against(ref, arch)
    ssm = arch == "mamba2-2.7b"
    assert (cache.layout["sub0"].get("ssm_state") == 2) == ssm
    assert cache.kv_seq == {"sub0": not ssm}


@pytest.mark.parametrize("arch", R.SERVE_ARCHS)
def test_cache_shards_match_jax(ref, arch):
    """Each mesh position's cache leaves on (2, 2), after the prefill and
    after the last decode step, against the JAX array's addressable shard
    on the same position: the same shape and values within 1e-4. The
    conv state (stated difference) holds the rank's x columns and the
    whole B and C of JAX's state, joined from its shards along 'model'."""
    from repro_torch.parallel import tp
    _, cfg = P.configs(arch)
    cache, prefilled = _serve_against(ref, arch)
    prefix = R.serve_prefix(arch) + "/cache"
    di = cfg.ssm.d_inner(cfg.d_model) if cfg.ssm is not None else 0
    n_checked = 0
    for when, rows in (("prefill", prefilled), ("decode", cache.rows)):
        for group, ranks in zip(cache.groups, rows):
            for k, (p, tree) in enumerate(zip(group.positions, ranks)):
                jax_tree = _unflat(ref, f"{prefix}/{when}/{p}")
                for path, leaf in tp.walk(tree):
                    want = jax_tree
                    for key in path:
                        want = want[key]
                    if path[-1] == "conv_state":
                        col = [_unflat(ref, f"{prefix}/{when}/{q}")
                               for q in group.positions]
                        whole = np.concatenate([t[path[0]][path[1]]
                                                for t in col], -1)
                        n = di // group.size
                        want = np.concatenate(
                            [whole[..., k * n:(k + 1) * n],
                             whole[..., di:]], -1)
                    assert tuple(leaf.shape) == want.shape, (when, p, path)
                    np.testing.assert_allclose(
                        leaf.float().numpy(), want.astype(np.float32),
                        atol=P.TOL, rtol=P.TOL, err_msg=f"{when} {p} {path}")
                    n_checked += 1
    assert n_checked == 2 * 4 * len(optim.tree_leaves(cache.rows[0][0]))


def test_prefill_and_decode_gather_block_by_block(monkeypatch):
    """Serving a sharded tree gathers no leaf whole and keeps no copy: each
    rank's slices come one block at a time (the embedding, each period's
    sub-layers, the final norm, the unembedding) and are dropped before
    the next block's are gathered; a leaf sharded over 'model' reaches a
    rank as its chunk only. The plan holds the shards plus the largest
    block's copied slices, far below the whole compute copy."""
    import weakref
    from repro_torch.parallel import tp
    cfg = tregistry.reduced_config("yi-6b")
    mesh, rules = mesh22(), rule_preset("baseline")
    params = api.init_params(cfg, 0, mesh, rules)
    pre, info = api.make_prefill_step(cfg, mesh, rules, capacity=8,
                                      batch_size=2)
    dec, _ = api.make_decode_step(cfg, mesh, rules, capacity=8, batch_size=2)
    monkeypatch.setattr(sh, "gather", lambda *a: pytest.fail("whole gather"))
    live, calls = [], []
    real = tp.gather_region

    def gather_region(leaf, region, position, device, dtype, block=None,
                      prefer=(), grad=None):
        out = real(leaf, region, position, device, dtype, block=block,
                   prefer=prefer, grad=grad)
        key = (id(leaf) if block is None else None, block)
        alive = {k for r, k in live if r() is not None}
        assert alive <= {key}, (alive, key)      # only this block's
        whole = leaf.shape[1:] if block is not None else leaf.shape
        if "model" in leaf.sharding.spec:
            assert out.numel() < int(np.prod(whole))
        if all(out.data_ptr() != s.data_ptr() for s in leaf.shards):
            live.append((weakref.ref(out), key))
        calls.append(key)
        return out
    monkeypatch.setattr(tp, "gather_region", gather_region)
    cache = api.make_cache(cfg, 2, 8, shardings=info["cache"])
    toks = torch.zeros((2, 4), dtype=torch.int64)
    _, cache = pre(params, {"tokens": toks}, cache)
    for i in range(3):
        _, cache = dec(params, cache, toks[:, :1], 4 + i)
    assert calls and all(r() is None for r, _ in live)
    parts = api.serving_bytes(cfg, mesh, rules, cfg.adtype)
    need = api.param_bytes(cfg, cfg.adtype, mesh=mesh, rules=rules)
    whole = api.param_bytes(cfg, cfg.adtype)
    assert need == [a + b + c for a, b, c in zip(*parts.values())]
    assert parts["shards"] == api.shard_param_bytes(cfg, mesh, rules,
                                                    cfg.adtype)
    assert 0 < max(parts["block"]) < whole / cfg.n_layers
    assert sum(parts["cache"]) == 0


def _unflat(ref, prefix):
    """The ``prefix + keystr(path)`` arrays of the reference as a nested
    dict."""
    out = {}
    for k, v in ref.items():
        if not k.startswith(prefix + "["):
            continue
        keys = [p.strip("'") for p in k[len(prefix) + 1:-1].split("][")]
        node = out
        for p in keys[:-1]:
            node = node.setdefault(p, {})
        node[keys[-1]] = v
    return out


def test_clip_norm_counts_each_element_once():
    """The clip's global norm over sharded gradients (replicated norms and
    biases among them) equals the norm of the gathered tree, and the
    clipped gradients are the gathered ones clipped."""
    cfg, _, params = P.port_train_params("h2o-danube-1.8b")
    mesh, rules = mesh22(), rule_preset("baseline")
    g = optim.tree_map(lambda p: torch.randn_like(p) * 3, params)
    sg = sharded_params(cfg, g, mesh, rules)
    leaves = optim.tree_leaves(sg)
    # norms and biases ('embed' over 'data') are copied along 'model'
    assert any(len(l.owners()) < len(l.shards) for l in leaves)
    norm = optim.global_norm(sg)
    assert abs(float(norm) - float(optim.global_norm(g))) <= 1e-6 * float(
        norm)
    clipped, _ = optim.clip_by_global_norm(sg, 1.0)
    want, _ = optim.clip_by_global_norm(g, 1.0)
    for a, b in zip(optim.tree_leaves(clipped), optim.tree_leaves(want)):
        assert torch.allclose(sh.gather(a, CPU), b, atol=1e-7, rtol=1e-6)


def test_replicated_copies_stay_bit_equal_and_shards_keep_their_shape():
    """After two sharded steps of olmoe (with top-k), every position
    holding a slice holds the same bits as the slice's owner, for the
    params, both moments and the error feedback; every shard has
    ``shard_shape``'s shape."""
    cfg, _, params = P.port_train_params("olmoe-1b-7b")
    _, state = run(cfg, params, mesh22(), rule_preset("baseline"), steps=2,
                   compression="topk")
    n_copies = 0
    for tree in (state["params"], state["opt"].mu, state["opt"].nu,
                 state["efb"]):
        for leaf in optim.tree_leaves(tree):
            shape = leaf.sharding.shard_shape(leaf.shape)
            idx = leaf.indices()
            for p, s in enumerate(leaf.shards):
                assert tuple(s.shape) == shape
                owner = next(o for o in leaf.owners() if idx[o] == idx[p])
                if owner != p:
                    n_copies += 1
                    assert torch.equal(s, leaf.shards[owner])
    assert n_copies > 0


def test_init_params_draws_each_shard_as_the_one_device_init():
    """``init_params(mesh=)`` equals the one-device draw sliced, for the
    f32 master and a bf16 compute tree, on (2, 2) and on whisper's
    tinydp (the batch over both axes)."""
    mesh = mesh22()
    for arch, preset in (("jamba-v0.1-52b", "baseline"),
                         ("whisper-base", "tinydp")):
        cfg = tregistry.reduced_config(arch)
        for dtype in (None, torch.bfloat16):
            one = api.init_params(cfg, 3, device="cpu", compute_dtype=dtype)
            got = api.init_params(cfg, 3, mesh, rule_preset(preset),
                                  compute_dtype=dtype)
            for a, b in zip(optim.tree_leaves(got), optim.tree_leaves(one)):
                assert a.dtype == b.dtype
                assert torch.equal(sh.gather(a, CPU), b)
                assert all(tuple(s.shape) == a.sharding.shard_shape(a.shape)
                           for s in a.shards)


def test_moe_rows_keep_the_global_token_groups():
    """``apply_moe`` on the rows of a batch, in row order with one
    ``RowContext``, gives the output and load-balance sums of the whole
    batch, with tokens dropped at capacity (capacity factor 0.5, and one
    group of 48 tokens spanning both rows; three rows of two groups)."""
    cfg = dataclasses.replace(
        tregistry.reduced_config("olmoe-1b-7b"), act_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    params = api.init_params(cfg, 1, device="cpu")["blocks"]["sub0"]["moe"]
    params = {k: v[0] for k, v in params.items()}
    for b, s, n_rows in ((2, 24, 2), (6, 1024, 3)):
        x = torch.randn((b, s, cfg.d_model), generator=torch.Generator()
                        .manual_seed(b))
        want, aux = tmoe.apply_moe(params, cfg, x)
        assert float(aux["moe_drop_frac"]) > 0
        ctx = sh.RowContext(n_rows)
        sharder = ActivationSharder()
        per = b // n_rows
        got = torch.cat([tmoe.apply_moe(
            params, cfg, x[r * per:(r + 1) * per],
            sharder=sharder.for_row(ctx, r).at_layer("l"))[0]
            for r in range(n_rows)])
        assert torch.allclose(got, want, atol=1e-6, rtol=0)
        counts = sum(ctx.stats[("l", r)]["counts"] for r in range(n_rows))
        kept = sum(ctx.stats[("l", r)]["kept"] for r in range(n_rows))
        assert float(kept) == pytest.approx(
            (1 - float(aux["moe_drop_frac"])) * b * s * cfg.moe.top_k)
        density = counts.float() / (b * s * cfg.moe.top_k)
        rmean = sum(ctx.stats[("l", r)]["router_sum"]
                    for r in range(n_rows)) / (b * s)
        assert float(cfg.moe.n_experts * torch.sum(density * rmean)) == \
            pytest.approx(float(aux["moe_aux_loss"]), rel=1e-5)


def test_jax_checkpoint_restores_onto_a_port_mesh(ref):
    """The JAX package's sharded danube state, saved by its store,
    restores onto the port's (2, 2) mesh leaf for leaf, bit for bit."""
    cfg, _, _ = P.port_train_params(R.CKPT_ARCH)
    mesh, rules = mesh22(), rule_preset("baseline")
    shapes, specs = api.param_specs(cfg, mesh, rules)
    target = {"params": shapes,
              "opt": optim.AdamState(step=0, mu=shapes, nu=shapes)}
    state = store.restore(ref["path"] + ".ckpt", target,
                          shardings=specs_to_shardings(
                              api.train_state_specs(specs), mesh))
    assert state["opt"].step == R.STEPS
    want = _unflat(ref, "ckpt")
    for (path, leaf), (_, w) in zip(store._flatten(state["params"]),
                                    store._flatten(want)):
        assert isinstance(leaf, sh.Sharded), path
        assert np.array_equal(sh.gather(leaf, CPU).numpy(), w), path
