"""The JAX oracles of the LM port's end-to-end tests
(``tests/test_torch_lm_dense.py``, ``tests/test_torch_lm_families.py``).

For one arch at ``reduced_config`` in f32: the JAX package's params
(``unbox(init_lm)`` / ``unbox(init_encdec)``, as numpy), a prompt of
``B`` x ``S`` tokens from a numpy seed (qwen2-vl: patch embeddings and
(3, B, S) M-RoPE positions whose t, h and w streams differ; whisper: frame
embeddings), ``DECODE`` teacher-forced decode tokens, and the JAX
functions' outputs on them, each jitted once: ``forward`` (or ``encode``
and ``decode_train``), ``loss_fn``, ``prefill`` and ``DECODE`` steps of
``decode_step``, with the caches after prefill and after the last step.

The unembedding rounds its input to bf16 (in both packages, whatever the
act dtype). A difference of 1e-7 between the two packages' f32 hidden
states then flips a bf16 rounding now and then, which moves the logits it
feeds by a whole bf16 step of that input (2^-8 of it, times the table:
up to 3e-4 here). So the logits are compared with both packages'
``layers.unembed`` swapped for one that widens its operands to f32
(:func:`f32_unembed`; the port's half is ``tests/torch_lm_f32.py``), the
same change on both sides; the shipped unembedding is held on its own, on
identical inputs (``tests/test_torch_lm_layers.py``), and ``loss_fn``
runs unswapped.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jlayers
from repro.common.param import unbox
from repro.configs import registry as jregistry
from repro.models import encdec as jencdec, lm as jlm
from repro_torch.configs import registry as tregistry
from tests.torch_lm_f32 import f32_unembed as torch_f32_unembed

B, S, DECODE = 2, 16, 8
SEED = 0
TOL = 1e-4            # atol and rtol, f32


def jax_unembed_f32(params, x):
    return jnp.einsum("...d,vd->...v", x.astype(jnp.float32),
                      params["table"].astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)


def f32_unembed():
    """Both packages' ``layers.unembed`` widened to f32 while inside."""
    return torch_f32_unembed((jlayers, jax_unembed_f32))


def configs(arch):
    """(JAX config, port config): reduced, f32 activations."""
    return (dataclasses.replace(jregistry.reduced_config(arch),
                                act_dtype="float32"),
            dataclasses.replace(tregistry.reduced_config(arch),
                                act_dtype="float32"))


def inputs(cfg):
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab_size, (B, S + DECODE)).astype(np.int32)
    out = {"tokens": toks[:, :S], "decode": toks[:, S:]}
    if cfg.is_encdec or cfg.frontend == "vision":
        out["embeddings"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32),
                              (3, B, S)).copy()
        pos[1] //= 2
        pos[2] %= 4
        out["positions"] = pos
    return out


def jax_batch(cfg, inp, labels=False):
    if cfg.is_encdec:
        return {"tokens": inp["tokens"], "enc_embeddings": inp["embeddings"]}
    if cfg.frontend == "vision":
        b = {"embeddings": inp["embeddings"], "positions": inp["positions"]}
        if labels:
            b["labels"] = inp["tokens"]
        return b
    return {"tokens": inp["tokens"]}


def torch_batch(cfg, inp, labels=False):
    return {k: torch.from_numpy(np.asarray(v))
            for k, v in jax_batch(cfg, inp, labels).items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def jax_oracle(arch):
    """The JAX side, once per arch and process."""
    cfg, _ = configs(arch)
    key = jax.random.PRNGKey(SEED)
    inp = inputs(cfg)
    out = {"inputs": inp}
    with f32_unembed():
        if cfg.is_encdec:
            params = _np(unbox(jencdec.init_encdec(key, cfg))[0])
            enc = jax.jit(lambda p, e: jencdec.encode(p, cfg, e))(
                params, inp["embeddings"])
            out["encode"] = np.asarray(enc)
            out["logits"] = np.asarray(jax.jit(
                lambda p, t, e: jencdec.decode_train(p, cfg, t, e))(
                params, inp["tokens"], enc))
            cache = jencdec.init_dec_cache(cfg, B, S + DECODE, S)
            pre = jax.jit(lambda p, b, c: jencdec.prefill(p, cfg, b, c))
            dec = jax.jit(lambda p, t, pos, c: jencdec.decode_step(
                p, cfg, t, pos, c))
        else:
            params = _np(unbox(jlm.init_lm(key, cfg))[0])
            logits, aux = jax.jit(lambda p, b: jlm.forward(p, cfg, b))(
                params, jax_batch(cfg, inp))
            out["logits"] = np.asarray(logits)
            out["aux"] = _np(aux)
            cache = jlm.init_cache(cfg, B, S + DECODE)
            pre = jax.jit(lambda p, b, c: jlm.prefill(p, cfg, b, c))
            dec = jax.jit(lambda p, t, pos, c: jlm.decode_step(
                p, cfg, t, pos, c))
        pl, cache = pre(params, jax_batch(cfg, inp), cache)
        out["prefill"] = np.asarray(pl)
        out["cache_prefill"] = _np(cache)
        steps = []
        for i in range(DECODE):
            lg, cache = dec(params, inp["decode"][:, i:i + 1],
                            jnp.int32(S + i), cache)
            steps.append(np.asarray(lg))
        out["decode"] = np.stack(steps)
        out["cache_decode"] = _np(cache)
    loss_fn = jencdec.loss_fn if cfg.is_encdec else jlm.loss_fn
    loss, metrics = jax.jit(lambda p, b: loss_fn(p, cfg, b))(
        params, jax_batch(cfg, inp, labels=True))
    out["loss"] = float(loss)
    out["loss_metrics"] = _np(metrics)
    out["params"] = params
    return out


def assert_close(got, want, what):
    """|got - want| <= TOL + TOL * |want| everywhere."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL,
                               err_msg=what)


def assert_tree_close(got, want, path="cache"):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_close(got[k], want[k], f"{path}/{k}")
        else:
            assert tuple(got[k].shape) == tuple(want[k].shape), (path, k)
            assert_close(got[k], want[k], f"{path}/{k}")


# ------------------------------------------------------------- the checks
def port_params(arch):
    from repro_torch.models import encdec as tencdec, lm as tlm
    _, cfg = configs(arch)
    mod = tencdec if cfg.is_encdec else tlm
    return cfg, mod, mod.from_jax_params(jax_oracle(arch)["params"], cfg,
                                          device="cpu")


def check_forward(arch):
    """forward (whisper: encode, decode_train) and the MoE aux loss."""
    from repro_torch.models import encdec as tencdec
    o = jax_oracle(arch)
    cfg, mod, params = port_params(arch)
    inp = o["inputs"]
    with f32_unembed():
        if cfg.is_encdec:
            enc = tencdec.encode(params, cfg,
                                 torch.from_numpy(inp["embeddings"]))
            assert_close(enc, o["encode"], "encode")
            logits = tencdec.decode_train(
                params, cfg, torch.from_numpy(inp["tokens"]), enc)
        else:
            logits, aux = mod.forward(params, cfg, torch_batch(cfg, inp))
            assert_close(aux["moe_aux_loss"], o["aux"]["moe_aux_loss"],
                         "moe_aux_loss")
    assert logits.dtype == torch.float32
    assert_close(logits, o["logits"], "logits")


def check_loss(arch):
    """loss_fn as shipped (bf16-rounded unembed in both) and its metrics."""
    o = jax_oracle(arch)
    cfg, mod, params = port_params(arch)
    loss, metrics = mod.loss_fn(params, cfg,
                                torch_batch(cfg, o["inputs"], labels=True))
    assert_close(loss, o["loss"], "loss")
    assert set(metrics) == set(o["loss_metrics"])
    for k, v in o["loss_metrics"].items():
        assert_close(metrics[k], v, k)


def _port_serve(arch):
    from repro_torch.parallel import api
    o = jax_oracle(arch)
    cfg, mod, params = port_params(arch)
    inp = o["inputs"]
    cache = api.make_cache(cfg, B, S + DECODE,
                           enc_len=S if cfg.is_encdec else 0, device="cpu")
    with f32_unembed():
        pl, cache = mod.prefill(params, cfg, torch_batch(cfg, inp), cache)
        cache_prefill = {k: tree_clone(v) for k, v in cache.items()}
        steps = []
        for i in range(DECODE):
            lg, cache = mod.decode_step(
                params, cfg, torch.from_numpy(inp["decode"][:, i:i + 1]),
                S + i, cache)
            steps.append(lg)
    return o, pl, cache_prefill, torch.stack(steps), cache


def tree_clone(tree):
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    return tree.clone()


def check_prefill(arch):
    """prefill's last-token logits and every cache leaf it fills."""
    o, pl, cache, _, _ = _port_serve(arch)
    assert_close(pl, o["prefill"], "prefill logits")
    assert_tree_close(cache, o["cache_prefill"])


def check_decode(arch):
    """DECODE teacher-forced steps' logits and the cache after them."""
    o, _, _, steps, cache = _port_serve(arch)
    assert_close(steps, o["decode"], "decode logits")
    assert_tree_close(cache, o["cache_decode"])


# ---------------------------------------------------------------- training
# The training checks (``tests/test_torch_lm_train_*.py``) run in f32 with
# the f32 unembedding on both sides: the gradients of the shipped one go
# through bf16 roundings, which an f32 difference of 1e-7 can flip.
# ``GRAD_Q_CHUNK`` makes S=16 run chunked attention in 4 query blocks, and
# a window of 4 (< S - q_chunk) runs h2o-danube's sliced-key branch.
GRAD_Q_CHUNK = 4
GRAD_WINDOW = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The training tests' modules run torch on one thread: the reduced
    models gain nothing from more, and the suite's parallel workers would
    only contend for the cores (imported into each module, it applies
    there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TRAIN_STEPS = 6
TRAIN_SEQ = 16
TRAIN_BATCH = 4


def train_configs(arch):
    """(JAX config, port config) of the gradient and train-step checks."""
    jc, tc = configs(arch)
    ch = {"attn_q_chunk": GRAD_Q_CHUNK}
    if jc.swa_window is not None:
        ch["swa_window"] = GRAD_WINDOW
    return dataclasses.replace(jc, **ch), dataclasses.replace(tc, **ch)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    """The JAX package's params of ``train_configs(arch)`` as numpy."""
    cfg, _ = train_configs(arch)
    key = jax.random.PRNGKey(SEED)
    init = jencdec.init_encdec if cfg.is_encdec else jlm.init_lm
    return _np(unbox(init(key, cfg))[0])


@functools.lru_cache(maxsize=None)
def jax_grad_oracle(arch):
    """(loss, aux, grads as numpy) of ``jax.value_and_grad(loss_fn)``."""
    cfg, _ = train_configs(arch)
    loss_fn = jencdec.loss_fn if cfg.is_encdec else jlm.loss_fn
    inp = inputs(cfg)
    with f32_unembed():
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p, b: loss_fn(p, cfg, b), has_aux=True))(
            jax_params(arch), jax_batch(cfg, inp, labels=True))
    return float(loss), _np(aux), _np(grads)


def port_train_params(arch, **changes):
    """(port config with ``changes``, its model module, the JAX params on
    the CPU)."""
    from repro_torch.models import encdec as tencdec, lm as tlm
    _, cfg = train_configs(arch)
    cfg = dataclasses.replace(cfg, **changes)
    mod = tencdec if cfg.is_encdec else tlm
    return cfg, mod, mod.from_jax_params(jax_params(arch), cfg,
                                          device="cpu")


def check_grads(arch, remat):
    """The port's loss, aux and every gradient leaf under ``remat``
    against ``jax.value_and_grad`` (whose config remats "full")."""
    from repro_torch.train import loop
    cfg, mod, params = port_train_params(arch, remat=remat)
    jloss, jaux, jgrads = jax_grad_oracle(arch)
    batch = torch_batch(cfg, inputs(cfg), labels=True)
    with f32_unembed():
        (loss, aux), grads = loop.value_and_grad(
            lambda p, b: mod.loss_fn(p, cfg, b), params, batch,
            has_aux=True)
    assert_close(loss, jloss, "loss")
    assert set(aux) == set(jaux)
    for k in jaux:
        assert_close(aux[k], jaux[k], k)
    assert_tree_close(grads, jgrads, path="grad")


def token_batches(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                  seq=TRAIN_SEQ, seed=SEED):
    """``steps`` numpy batches of the JAX package's token stream (plus
    frame embeddings for whisper, drawn from ``seed`` and the step)."""
    from repro.data.tokens import DataConfig, SyntheticTokens
    src = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                     global_batch=batch, seed=seed))
    out = []
    for i in range(steps):
        b = src.batch(i)
        if cfg.is_encdec:
            rng = np.random.default_rng((seed, i))
            b["enc_embeddings"] = rng.standard_normal(
                (batch, seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def auto_mesh():
    """A one-device ("data", "model") mesh with Auto axes: jax 0.9's
    ``make_local_mesh`` gives Explicit ones, on which the JAX LM steps
    fail (ROADMAP C2)."""
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


JAX_STEP_KEYS = ("loss", "grad_norm", "ce")


@functools.lru_cache(maxsize=None)
def jax_train_curve(arch, compression=None):
    """Per-step metrics (``JAX_STEP_KEYS`` the step reports) of
    ``TRAIN_STEPS`` steps of the JAX ``api.make_train_step``."""
    from repro.parallel import api as japi
    cfg, _ = train_configs(arch)
    tc = japi.TrainConfig(compression=compression)
    mesh = auto_mesh()
    rows = []
    with f32_unembed():
        step, sh = japi.make_train_step(cfg, mesh, train_cfg=tc)
        state = jax.device_put(
            japi.make_train_state(jax.tree.map(jnp.asarray, jax_params(arch)),
                                  compression=compression is not None),
            sh["state"])
        for b in token_batches(cfg):
            state, m = step(state, b)
            rows.append({k: float(m[k]) for k in JAX_STEP_KEYS if k in m})
    return rows


def port_train_curve(arch, compression=None, num_microbatches=1,
                     steps=TRAIN_STEPS):
    """The port's ``api.make_train_step`` on the same params and batches:
    per-step metrics (``JAX_STEP_KEYS``)."""
    from repro_torch.parallel import api as tapi
    cfg, _, params = port_train_params(arch)
    tc = tapi.TrainConfig(compression=compression,
                          num_microbatches=num_microbatches)
    step, _ = tapi.make_train_step(cfg, train_cfg=tc)
    state = tapi.make_train_state(params, compression=compression is not None)
    rows = []
    with f32_unembed():
        for b in token_batches(cfg, steps=steps):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            rows.append({k: float(m[k]) for k in JAX_STEP_KEYS if k in m})
    return rows, state


def assert_curves_close(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (i, g, w)
        for k in w:
            assert_close(g[k], w[k], f"step {i} {k}")
