"""The JAX package's sharded LM steps on eight forced host devices, written
to an ``.npz`` for ``tests/test_torch_lm_shard_numerics.py`` (which runs
this as a subprocess, since the device count is fixed when JAX starts):

    PYTHONPATH=src python -m tests.jax_lm_sharding_reference out.npz

On a (2, 2) ("data", "model") mesh of the first four devices, with Auto
axes (jax 0.9's ``make_mesh`` default is Explicit, on which the JAX LM
steps fail: ROADMAP C2), each function jitted once, in f32 with the
unembedding widened to f32 on both sides (``tests/torch_lm_parity.py``):

  * ``STEPS`` steps of ``api.make_train_step`` for reduced h2o-danube and
    olmoe (their per-step loss, grad norm and CE), and for danube with
    top-k compression;
  * the same two archs' loss and every gradient leaf of
    ``jax.value_and_grad`` of the train step's loss (the compute cast on
    the params' shardings, the activation hints on) on the first batch,
    as ``grad/<arch><keystr path>``, and those of ``GRAD_ARCHS``;
  * the sharded prefill and ``DECODE`` teacher-forced decode steps of
    ``SERVE_ARCHS`` (yi-6b as ``serve/params<keystr path>`` and
    ``serve/logits``, the others under ``serve/<arch>/``), and each mesh
    position's shard of every cache leaf after the prefill and after the
    last decode step (``.../cache/<prefill|decode>/<position><keystr
    path>``, positions in row-major order of the mesh);
  * danube's train state after its steps, saved with the JAX checkpoint
    store next to the ``.npz`` (``<out>.ckpt/``), and its params in the
    ``.npz`` (``ckpt<keystr path>``), for the cross-package restore.

Params and batches are the parity helper's (``jax_params``,
``token_batches``), so the port reads the same inputs.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.common.param import unbox  # noqa: E402
from repro.common.partitioning import (DEFAULT_RULES,  # noqa: E402
                                       ActivationSharder)
from repro.models import lm as jlm  # noqa: E402
from repro.parallel import api as japi  # noqa: E402
from tests import torch_lm_parity as P  # noqa: E402

STEPS = 4
TRAIN_ARCHS = ("h2o-danube-1.8b", "olmoe-1b-7b")
# gradient leaves only (no train curve): the SSM split by heads
GRAD_ARCHS = ("mamba2-2.7b",)
TOPK_ARCH = "h2o-danube-1.8b"
SERVE_ARCH = "yi-6b"
# the tensor-parallel serving oracles: dense, MoE (expert parallel), SSM
SERVE_ARCHS = (SERVE_ARCH, "olmoe-1b-7b", "mamba2-2.7b")
CKPT_ARCH = "h2o-danube-1.8b"


def mesh22():
    return jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])


def _train(arch, mesh, compression=None):
    cfg, _ = P.train_configs(arch)
    tc = japi.TrainConfig(compression=compression)
    step, sh = japi.make_train_step(cfg, mesh, train_cfg=tc)
    state = jax.device_put(
        japi.make_train_state(jax.tree.map(jnp.asarray, P.jax_params(arch)),
                              compression=compression is not None),
        sh["state"])
    rows = {k: [] for k in ("loss", "grad_norm", "ce")}
    for b in P.token_batches(cfg, steps=STEPS):
        state, m = step(state, b)
        for k in rows:
            rows[k].append(float(m[k]))
    return {k: np.asarray(v) for k, v in rows.items()}, state


def _grads(arch, mesh, out):
    """``jax.value_and_grad`` of the sharded train step's loss on the
    first batch (its ``compute_grads``, f32)."""
    cfg, _ = P.train_configs(arch)
    sharder = ActivationSharder(mesh, DEFAULT_RULES)
    _, sh = japi.make_train_step(cfg, mesh)
    pshard = sh["state"]["params"]

    def loss_of(p, b):
        p = japi.cast_params_for_compute(p, cfg.adtype, pshard)
        return jlm.loss_fn(p, cfg, b, sharder=sharder)
    params = jax.device_put(jax.tree.map(jnp.asarray, P.jax_params(arch)),
                            pshard)
    batch = P.token_batches(cfg, steps=1)[0]
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        params, batch)
    out[f"grad/{arch}/loss"] = np.asarray(loss)
    _flat(grads, f"grad/{arch}", out)


def serve_prefix(arch):
    return "serve" if arch == SERVE_ARCH else f"serve/{arch}"


def _serve(mesh, out, arch):
    cfg, _ = P.configs(arch)
    inp = P.inputs(cfg)
    np_params = P._np(unbox(jlm.init_lm(jax.random.PRNGKey(P.SEED),
                                        cfg))[0])
    _flat(np_params, serve_prefix(arch) + "/params", out)
    params = jax.tree.map(jnp.asarray, np_params)
    cap = P.S + P.DECODE
    pre, psh = japi.make_prefill_step(cfg, mesh, capacity=cap,
                                      batch_size=P.B)
    dec, _ = japi.make_decode_step(cfg, mesh, capacity=cap,
                                     batch_size=P.B)
    params = jax.device_put(params, psh["params"])
    cache = japi.make_cache(cfg, P.B, cap, shardings=psh["cache"])
    logits, cache = pre(params, {"tokens": inp["tokens"]}, cache)
    _shards(mesh, cache, serve_prefix(arch) + "/cache/prefill", out)
    steps = [np.asarray(logits)]
    for i in range(P.DECODE):
        logits, cache = dec(params, cache, inp["decode"][:, i:i + 1],
                            jnp.int32(P.S + i))
        steps.append(np.asarray(logits))
    _shards(mesh, cache, serve_prefix(arch) + "/cache/decode", out)
    out[serve_prefix(arch) + "/logits"] = np.stack(steps)


def _shards(mesh, tree, prefix, out):
    """Each mesh position's shard of every leaf of ``tree``, as
    ``prefix/<position><keystr path>``."""
    devices = list(mesh.devices.flat)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        for shard in leaf.addressable_shards:
            p = devices.index(shard.device)
            out[f"{prefix}/{p}{jax.tree_util.keystr(path)}"] = \
                np.asarray(shard.data)


def _flat(tree, prefix, out):
    """Each leaf of ``tree`` as ``prefix + keystr(path)``."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)


def main(out_path):
    mesh = mesh22()
    out = {}
    with P.f32_unembed():
        for arch in TRAIN_ARCHS:
            rows, state = _train(arch, mesh)
            for k, v in rows.items():
                out[f"train/{arch}/{k}"] = v
            if arch == CKPT_ARCH:
                ckpt = out_path + ".ckpt"
                jstore.save(state, STEPS, ckpt)
                _flat(state["params"], "ckpt", out)
            _grads(arch, mesh, out)
        for arch in GRAD_ARCHS:
            _grads(arch, mesh, out)
        rows, _ = _train(TOPK_ARCH, mesh, compression="topk")
        for k, v in rows.items():
            out[f"topk/{TOPK_ARCH}/{k}"] = v
        for arch in SERVE_ARCHS:
            _serve(mesh, out, arch)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
