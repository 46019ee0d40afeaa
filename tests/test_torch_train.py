"""repro_torch's training path against the JAX package's, on the CPU:
``train/optim`` (Adam, its schedule and clipping), ``train/loop``
(``chunk_plan``, ``TrainEngine``), ``core/train`` (losses, batches, the
loop) and the analytic volume of ``data/scenes``.

The two packages draw different random numbers, so the port's runs take
the JAX package's initial params (``init_field`` from its seed, through
``from_jax_params``) and its batches (``make_batch`` at ``fold_in(k_data,
step)``, as numpy) through ``train_field(params=..., batch_fn=...)``.

Tolerances, f32: losses, gradients and Adam's moments within 1e-5 of the
value's (the leaf's max) magnitude: the same operations summed in another
order. Parameters after an update: Adam moves an entry by lr * m / (sqrt(v)
+ eps), a ratio that magnifies an entry's own relative error, and for a
gradient near 0 that is lr * g / (|g| + eps): +-lr for any g far above
eps = 1e-10, whatever its size. So an entry whose gradient is small
against the leaf's max (where the gradients' bar says little of its own
digits) can step by another amount, or the other way, up to 2 lr apart.
The teacher-forced check therefore holds the optimizer to 1e-6 on the
same gradients and the gradients to 1e-5, and bounds the step apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import train as jtrain
from repro.data import scenes as jscenes
from repro.core import render as jrender
from repro.train import loop as jloop
from repro.train import optim as joptim
from repro_torch.core import fields as tfields
from repro_torch.core import train as ttrain
from repro_torch.data import scenes as tscenes
from repro_torch.train import compression as tcomp
from repro_torch.train import loop as tloop
from repro_torch.train import optim as toptim
from tests.test_torch_grad import _rel_err, _t_batch, jax_start

TOL = 1e-5


def _np_tree(tree):
    return {k: (_np_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def _t_tree(tree):
    return {k: (_t_tree(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v, np.float32)))
            for k, v in tree.items()}


_ADAM_CFGS = {
    "plain": dict(),
    "warmup_decay": dict(lr_warmup_steps=3, lr_decay_steps=7),
    "clip_wd": dict(grad_clip=0.5, weight_decay=1e-3, lr=3e-3),
    "all": dict(grad_clip=2.0, lr_warmup_steps=2, lr_decay_steps=5,
                weight_decay=1e-2),
}


@pytest.mark.parametrize("name", sorted(_ADAM_CFGS))
def test_adam_update_matches_jax(name):
    """Four updates on the same gradients (one leaf's gradient exactly 0
    in places): params, moments, lr and, with clipping, the global norm."""
    kw = _ADAM_CFGS[name]
    jcfg, tcfg = joptim.AdamConfig(**kw), toptim.AdamConfig(**kw)
    rng = np.random.default_rng(len(name))
    params = {"grid": rng.uniform(-1, 1, (2, 64, 2)).astype(np.float32),
              "mlp": {"w_in": rng.normal(size=(8, 16)).astype(np.float32),
                      "w_out": rng.normal(size=(16, 3)).astype(np.float32)}}
    jp, jst = params, joptim.adam_init(params)
    tp = _t_tree(params)
    tst = toptim.adam_init(tp)
    for i in range(4):
        grads = {"grid": rng.normal(size=(2, 64, 2)).astype(np.float32),
                 "mlp": {"w_in": rng.normal(size=(8, 16)).astype(np.float32)
                         * 10.0 ** (i - 2),
                         "w_out": rng.normal(size=(16, 3)).astype(
                             np.float32)}}
        grads["grid"][:, ::3] = 0.0                 # untouched rows
        jp, jst, jm = joptim.adam_update(grads, jst, jp, jcfg)
        tp, tst, tm = toptim.adam_update(_t_tree(grads), tst, tp, tcfg)
        assert tst.step == int(jst.step) == i + 1
        assert abs(tm["lr"] - float(jm["lr"])) <= TOL * float(jm["lr"])
        if "grad_clip" in kw:
            assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
                <= TOL * float(jm["grad_norm"])
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            keys = [p.key for p in path]

            def at(tree):
                for k in keys:
                    tree = tree[k]
                return tree
            np.testing.assert_allclose(at(tp).numpy(), leaf, rtol=TOL,
                                       atol=TOL * float(jm["lr"]))
            assert _rel_err(at(tst.mu).numpy(), at(jst.mu)) <= TOL
            assert _rel_err(at(tst.nu).numpy(), at(jst.nu)) <= TOL


def test_lr_schedule_matches_jax():
    for kw in _ADAM_CFGS.values():
        jcfg, tcfg = joptim.AdamConfig(**kw), toptim.AdamConfig(**kw)
        for step in range(0, 12):
            j = float(joptim.lr_schedule(jcfg, jnp.int32(step)))
            assert abs(toptim.lr_schedule(tcfg, step) - j) <= TOL * max(j,
                                                                        1e-12)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(7, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(11,)).astype(np.float32)}}
    jn = float(joptim.global_norm(tree))
    assert abs(float(toptim.global_norm(_t_tree(tree))) - jn) <= TOL * jn
    jc, _ = joptim.clip_by_global_norm(tree, 1.0)
    tc, tn = toptim.clip_by_global_norm(_t_tree(tree), 1.0)
    assert abs(float(tn) - jn) <= TOL * jn
    assert _rel_err(tc["b"]["c"].numpy(), jc["b"]["c"]) <= TOL


@pytest.mark.parametrize("start,steps,chunk", [
    (0, 10, 4), (0, 16, 16), (3, 10, 4), (5, 6, 16), (0, 1, 1), (7, 7, 3),
    (0, 33, 8), (12, 40, 16)])
def test_chunk_plan_matches_jax(start, steps, chunk):
    assert tloop.chunk_plan(start, steps, chunk) == jloop.chunk_plan(
        start, steps, chunk)


_BATCH = {"nerf": 48, "gia": 128, "nsdf": 128, "nvr": 48}


@pytest.mark.parametrize("app", ["nerf", "gia", "nsdf", "nvr"])
def test_loss_curves_match_jax_reference(app):
    """Six steps of the port's engine (chunks of 4) on the JAX package's
    initial params and batches against the JAX per-step reference loop:
    every logged loss within 1e-5 of its size."""
    cj, ct, p0, batch = jax_start(app, _BATCH[app])
    _, jh = jtrain.train_field_reference(cj, steps=6,
                                         batch_size=_BATCH[app], seed=0,
                                         log_every=1)
    _, th = ttrain.train_field(
        ct, steps=6, log_every=1, chunk_steps=4, device="cpu",
        params=tfields.from_jax_params(p0, ct, "cpu"),
        batch_fn=lambda i: _t_batch(batch(i)))
    assert [s for s, _ in th] == [s for s, _ in jh] == list(range(6))
    for (_, a), (_, b) in zip(jh, th):
        assert abs(b - float(a)) <= TOL * abs(float(a))


@pytest.mark.parametrize("app", ["nerf", "gia", "nsdf", "nvr"])
def test_teacher_forced_steps_match_jax(app):
    """Each of three steps starts the port from the JAX package's params
    and Adam state at that step. The loss and every gradient agree to
    1e-5; the gradients' signs agree except where a gradient is within
    1e-5 of the leaf's max of 0. The port's update from that state on its
    own gradients equals the JAX package's adam_update on the same
    gradients to 1e-6, and is at most 2 lr (plus that) from the JAX step,
    which differs only by the gradients' rounding."""
    cj, ct, params, batch = jax_start(app, _BATCH[app])
    jstep = jtrain.make_field_train_step(cj)
    jopt = joptim.adam_init(params)
    lr = toptim.AdamConfig().lr
    for i in range(3):
        b = batch(i)
        jl, jg = jax.value_and_grad(jtrain.field_loss)(params, cj, b)
        new_p, new_opt, jm = jstep(params, jopt, b)
        tp = tfields.from_jax_params(_np_tree(params), ct, "cpu")
        topt = toptim.AdamState(step=int(jopt.step),
                                mu=tfields.from_jax_params(
                                    _np_tree(jopt.mu), ct, "cpu"),
                                nu=tfields.from_jax_params(
                                    _np_tree(jopt.nu), ct, "cpu"))
        tl, tg = tloop.value_and_grad(
            lambda p, bb: ttrain.field_loss(p, ct, bb), tp, _t_batch(b))
        assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
        assert abs(float(jm["loss"]) - float(jl)) <= TOL * abs(float(jl))
        on_tg, _, _ = joptim.adam_update(_np_tree(tg), jopt, params,
                                         joptim.AdamConfig())
        tp, topt, _ = toptim.adam_update(tg, topt, tp, toptim.AdamConfig())
        for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
            keys = [p.key for p in path]

            def at(tree):
                for k in keys:
                    tree = tree[k]
                return tree
            g_j, g_t = np.asarray(leaf), at(tg).numpy()
            assert _rel_err(g_t, g_j) <= TOL, keys
            tiny = np.abs(g_j) <= TOL * np.abs(g_j).max()
            assert np.all((np.sign(g_t) == np.sign(g_j)) | tiny), keys
            np.testing.assert_allclose(at(tp).numpy(), np.asarray(at(on_tg)),
                                       rtol=0, atol=1e-6)
            assert np.abs(at(tp).numpy() - np.asarray(at(new_p))).max() \
                <= 2 * lr + 1e-6, keys
        params, jopt = jax.tree.map(np.asarray, new_p), new_opt


def test_engine_matches_per_step_reference():
    """The engine (chunks of 2 over 5 steps) and the per-step loop take
    the same batches of the RNG contract and give the same losses, bit for
    bit on the CPU, and the same params."""
    _, ct, _, _ = jax_start("gia", 64)
    pe, he = ttrain.train_field(ct, steps=5, batch_size=64, seed=3,
                                log_every=1, chunk_steps=2, device="cpu")
    pr, hr = ttrain.train_field_reference(ct, steps=5, batch_size=64,
                                          seed=3, log_every=1, device="cpu")
    assert he == hr
    assert torch.equal(pe["grid"], pr["grid"])
    _, h2 = ttrain.train_field(ct, steps=5, batch_size=64, seed=4,
                               log_every=1, device="cpu")
    assert h2 != he


def test_engine_reports_every_step_once_per_chunk():
    """on_metrics sees every step's loss, psnr, lr and dt after its chunk;
    on_chunk_end fires at the grid's chunk ends; callback at log_every."""
    _, ct, _, _ = jax_start("nsdf", 32)
    rows, ends, logged = [], [], []
    step_fn = tloop.make_scanned_step(
        lambda p, b: ttrain.field_loss(p, ct, b),
        toptim.AdamConfig(lr_warmup_steps=4, grad_clip=1.0))
    params = tfields.init_field(ct, torch.Generator().manual_seed(0), "cpu")
    engine = tloop.TrainEngine(
        tloop.EngineConfig(steps=7, chunk_steps=3), step_fn,
        batch_fn=lambda i: ttrain.make_batch(
            ct, ttrain.batch_generator(0, i, "cpu"), 32),
        on_chunk_end=lambda end, st: ends.append(end))
    _, history = engine.run(tloop.init_train_state(params),
                            on_metrics=lambda i, r, st: rows.append(r))
    assert ends == [2, 5, 6]
    assert rows == history and [r["step"] for r in rows] == list(range(7))
    for r in rows:
        assert set(r) == {"step", "loss", "psnr", "lr", "dt", "grad_norm"}
        assert abs(r["psnr"] + 10 * np.log10(r["loss"])) <= 1e-4
        assert r["dt"] > 0
    assert [r["lr"] for r in rows[:4]] == pytest.approx(
        [1e-2 * min(1, (s + 2) / 4) for s in range(4)])
    _, hist = ttrain.train_field(ct, steps=7, batch_size=32, log_every=3,
                                 device="cpu",
                                 callback=lambda i, l, p: logged.append(i))
    assert [s for s, _ in hist] == logged == [0, 3, 6]


@pytest.mark.parametrize("kw", [
    dict(grad_accum=2), dict(compression="topk"), dict(ckpt_dir="x"),
    dict(mesh=object()), dict(occupancy_res=16)])
def test_train_field_refuses_what_is_not_ported(kw, tmp_path):
    """Only the data-parallel mesh (A11) is refused as not ported;
    occupancy grids are refused for the apps that do not ray-march, as in
    the JAX package; the rest run."""
    _, ct, _, _ = jax_start("gia", 8)
    if "ckpt_dir" in kw:
        kw = {"ckpt_dir": str(tmp_path / kw["ckpt_dir"])}
    if "mesh" in kw:
        with pytest.raises(NotImplementedError, match="not ported"):
            ttrain.train_field(ct, steps=1, batch_size=8, device="cpu", **kw)
    elif "occupancy_res" in kw:
        with pytest.raises(ValueError, match="ray"):
            ttrain.train_field(ct, steps=1, batch_size=8, device="cpu", **kw)
    else:
        _, hist = ttrain.train_field(ct, steps=2, batch_size=8,
                                     device="cpu", log_every=1, **kw)
        assert [s for s, _ in hist] == [0, 1]
        assert all(np.isfinite(l) for _, l in hist)


# ------------------------------------------------ gradient accumulation
@pytest.mark.parametrize("app", ["gia", "nerf"])
def test_grad_accum_matches_single_pass(app):
    """grad_accum=2 against 1 on one batch, before Adam: the loss and every
    gradient leaf within 1e-6 of its size (the leaf's max): the mean of
    two half-batch means is the full mean, summed in another order. (Not
    the params after Adam, which divides by sqrt(v) and so turns a
    gradient's last bit near 0 into a visible step.) The engine step's
    loss metric is the same accumulated loss."""
    _, ct, p0, batch = jax_start(app, 128 if app == "gia" else 32)
    params = tfields.from_jax_params(p0, ct, "cpu")
    b = _t_batch(batch(0))

    def loss_fn(p, bb):
        return ttrain.field_loss(p, ct, bb)
    l1, g1 = tloop.value_and_grad(loss_fn, params, b)
    l2, g2 = tloop.accumulated_value_and_grad(loss_fn, params, b, 2)
    assert abs(float(l2) - float(l1)) <= 1e-6 * abs(float(l1))
    for a, c in zip(toptim.tree_leaves(g1), toptim.tree_leaves(g2)):
        assert _rel_err(c.numpy(), a.numpy()) <= 1e-6
    step2 = tloop.make_scanned_step(loss_fn, toptim.AdamConfig(),
                                    grad_accum=2)
    _, m = step2(tloop.init_train_state(
        tfields.from_jax_params(p0, ct, "cpu")), 0, b)
    assert float(m["loss"]) == float(l2)


def test_grad_accum_refuses_a_batch_it_does_not_divide():
    _, ct, p0, batch = jax_start("gia", 10)
    step = tloop.make_scanned_step(
        lambda p, b: ttrain.field_loss(p, ct, b), toptim.AdamConfig(),
        grad_accum=3)
    with pytest.raises(ValueError, match="does not divide"):
        step(tloop.init_train_state(tfields.from_jax_params(p0, ct, "cpu")),
             0, _t_batch(batch(0)))


def test_grad_accum_training_matches_single_pass_losses():
    """Eight steps with grad_accum=4 against 1 on the same batches: every
    loss within 1e-5 of its size (Adam amplifies the gradients' rounding
    into the params, as for the JAX reference; the losses stay close)."""
    _, ct, p0, batch = jax_start("gia", 64)
    hists = []
    for k in (1, 4):
        _, h = ttrain.train_field(
            ct, steps=8, log_every=1, chunk_steps=4, grad_accum=k,
            device="cpu", params=tfields.from_jax_params(p0, ct, "cpu"),
            batch_fn=lambda i: _t_batch(batch(i)))
        hists.append([l for _, l in h])
    for a, c in zip(*hists):
        assert abs(c - a) <= TOL * abs(a)


# ------------------------------------------------------------ compression
def test_engine_efb_invariant():
    """After one engine step the state's error feedback holds exactly what
    top-k did not send: kept + efb_new == g + efb_old (efb_old = 0), and
    equals compress_topk of the step's own gradient."""
    _, ct, p0, batch = jax_start("gia", 128)
    params = tfields.from_jax_params(p0, ct, "cpu")
    b = _t_batch(batch(0))
    frac = 0.05
    _, g = tloop.value_and_grad(lambda p, bb: ttrain.field_loss(p, ct, bb),
                                params, b)
    step_fn = tloop.make_scanned_step(
        lambda p, bb: ttrain.field_loss(p, ct, bb), toptim.AdamConfig(),
        compression="topk", compression_topk=frac)
    state = tloop.init_train_state(params, compression="topk")
    assert set(state["efb"]) == {"grid"}
    state1, _ = step_fn(state, 0, b)
    kept, efb = tcomp.compress_topk(g["grid"], torch.zeros_like(g["grid"]),
                                    frac)
    assert torch.equal(state1["efb"]["grid"], efb)
    assert torch.equal(kept + efb, g["grid"])


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compressed_loss_curve_matches_jax(scheme):
    """24 steps with the table gradient compressed, the port's engine and
    the JAX package's, on the JAX package's params and batches: every loss
    within 1e-5 of its size (measured: 2e-7 for top-k, 1.4e-6 for int8)."""
    cj, ct, p0, batch = jax_start("gia", 256)
    step_fn = jloop.make_scanned_step(
        lambda p, b: jtrain.field_loss(p, cj, b), joptim.AdamConfig(),
        compression=scheme, compression_topk=0.05)
    jl, tl = [], []
    jloop.TrainEngine(jloop.EngineConfig(steps=24, chunk_steps=8), step_fn,
                      host_batch_fn=batch).run(
        jloop.init_train_state(p0, compression=scheme),
        on_metrics=lambda i, r, st: jl.append(r["loss"]))
    ttrain.train_field(
        ct, steps=24, chunk_steps=8, compression=scheme, device="cpu",
        params=tfields.from_jax_params(p0, ct, "cpu"),
        batch_fn=lambda i: _t_batch(batch(i)),
        on_metrics=lambda i, r, st: tl.append(r["loss"]))
    assert len(tl) == len(jl) == 24
    for a, b in zip(jl, tl):
        assert abs(b - a) <= TOL * abs(a)


def test_topk_training_close_to_uncompressed():
    """200 steps of gia with top-k (5%) on the table gradient against the
    port's own uncompressed run, same seed: the mean loss of the last 10
    steps within 10% of the uncompressed run's (measured 3.4%; 4.9% at
    seed 1), and below half the first loss."""
    _, ct, _, _ = jax_start("gia", 8)
    means = {}
    for scheme in (None, "topk"):
        losses = []
        ttrain.train_field(ct, steps=200, batch_size=256, seed=0,
                           device="cpu", compression=scheme,
                           on_metrics=lambda i, r, st: losses.append(
                               r["loss"]))
        means[scheme] = float(np.mean(losses[-10:]))
        assert means[scheme] < 0.5 * losses[0]
    assert abs(means["topk"] - means[None]) / means[None] < 0.10


def test_train_field_keeps_the_callers_params():
    _, ct, p0, _ = jax_start("gia", 16)
    start = tfields.from_jax_params(p0, ct, "cpu")
    before = start["grid"].clone()
    trained, _ = ttrain.train_field(ct, steps=2, batch_size=16,
                                    device="cpu", params=start)
    assert torch.equal(start["grid"], before)
    assert not torch.equal(trained["grid"], before)
    assert not trained["grid"].requires_grad


@pytest.mark.parametrize("app", ["nerf", "gia", "nsdf", "nvr"])
def test_batches_follow_the_rng_contract(app):
    """One (seed, step) gives one batch; another step another. Shapes and
    ranges as the JAX package's batch makers give them."""
    _, ct, _, _ = jax_start(app, 8)

    def make(seed, step):
        return ttrain.make_batch(ct, ttrain.batch_generator(seed, step,
                                                            "cpu"), 40)
    a, b, c = make(1, 2), make(1, 2), make(1, 3)
    assert a.keys() == b.keys() == c.keys()
    for k in a:                # every ray starts at the camera's eye
        assert torch.equal(a[k], b[k])
        assert k == "origins" or not torch.equal(a[k], c[k])
    if app in ("gia", "nsdf"):
        pts = a["points"]
        assert pts.shape == (40, 2 if app == "gia" else 3)
        assert a["target"].shape == (40, 3 if app == "gia" else 1)
        assert float(pts.min()) >= -0.2 and float(pts.max()) <= 1.2
    else:
        assert a["origins"].shape == a["dirs"].shape == (40, 3)
        assert a["target"].shape == (40, 3)
        assert 0.0 <= float(a["target"].min()) <= float(a["target"].max()) \
            <= 1.0
    assert ttrain.DATA_STREAM + 1 * 2 ** 32 + 2 == \
        ttrain.batch_generator(1, 2, "cpu").initial_seed()


def test_volume_field_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for dirs in (None, d):
        ref = jscenes.volume_field(jnp.asarray(p), None if dirs is None
                                   else jnp.asarray(dirs))
        got = tscenes.volume_field(torch.from_numpy(p), None if dirs is None
                                   else torch.from_numpy(dirs))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)


def test_gt_render_rays_matches_jax():
    """The analytic volume's pixels on the same rays and the same
    stratified draw (JAX's, drawn from its key as its render_rays does)."""
    cam = jscenes.default_camera(16, 16)
    pix = jnp.arange(0, 256, 3)
    o, d = jrender.make_rays(cam, pix)
    key = jax.random.PRNGKey(7)
    u = jax.random.uniform(key, (o.shape[0], 64))
    ref = jscenes.gt_render_rays(o, d, n_samples=64, rng=key)
    got = tscenes.gt_render_rays(torch.from_numpy(np.asarray(o)),
                                 torch.from_numpy(np.asarray(d)),
                                 n_samples=64,
                                 u=torch.from_numpy(np.asarray(u)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    mid = jscenes.gt_render_rays(o, d, n_samples=64)
    got_mid = tscenes.gt_render_rays(torch.from_numpy(np.asarray(o)),
                                     torch.from_numpy(np.asarray(d)))
    np.testing.assert_allclose(got_mid.numpy(), np.asarray(mid), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("app", ["gia", "nerf"])
def test_sparse_table_stats_matches_jax(app):
    cj, ct, p0, batch = jax_start(app, 32)
    b = batch(0)
    ref = jtrain.sparse_table_stats(cj, p0, b)
    got = ttrain.sparse_table_stats(ct, tfields.from_jax_params(p0, ct,
                                                                "cpu"),
                                    _t_batch(b))
    assert got["table_rows"] == ref["table_rows"]
    assert abs(got["touched_rows_frac"] - ref["touched_rows_frac"]) <= 1e-6


def test_psnr():
    assert ttrain.psnr(0.01) == pytest.approx(jtrain.psnr(0.01))
    assert ttrain.psnr(0.0) == pytest.approx(120.0)
