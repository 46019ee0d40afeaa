"""The JAX package's dry-run oracles, written to a JSON file for
``tests/test_torch_dryrun.py`` (which runs this as a subprocess, since the
device count is fixed when JAX starts, and never imports it: it sets the
device count of the process that imports it):

    PYTHONPATH=src python -m tests.jax_dryrun_reference out.json

On 8 forced host devices (the JAX dry run's module asks for 512 when it is
imported first; here JAX starts before it is imported, so its request has
no effect):

  * ``train_overrides``: ``repro.launch.dryrun.TRAIN_OVERRIDES``;
  * ``prefill_dot_flops``: the FLOPs of every ``dot_general`` in the jaxpr
    of the JAX prefill step (``scan_layers=False``; a scan's body counted
    once per iteration) of reduced qwen2-7b and olmoe-1b-7b at
    ``PREFILL`` (batch, tokens);
  * ``train_dot_flops``: the same for ``jax.value_and_grad`` of reduced
    qwen2-7b's loss at ``TRAIN`` (remat's recomputation included, as the
    jaxpr holds it);
  * ``argument_bytes``: ``memory_analysis().argument_size_in_bytes`` of the
    compiled sharded train step of reduced h2o-danube-1.8b at ``TRAIN`` on
    a (2, 2) ("data", "model") mesh with Auto axes (jax 0.9's default
    Explicit axes fail the LM steps: ROADMAP C2).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

PREFILL = (2, 16)
TRAIN = (4, 16)
PREFILL_ARCHS = ("qwen2-7b", "olmoe-1b-7b")
TRAIN_FLOPS_ARCH = "qwen2-7b"
ARGS_ARCH = "h2o-danube-1.8b"


def _jaxprs(v):
    from jax.extend import core as jcore
    if isinstance(v, jcore.ClosedJaxpr):
        return [v.jaxpr]
    if isinstance(v, jcore.Jaxpr):
        return [v]
    if isinstance(v, (list, tuple)):
        return [j for x in v for j in _jaxprs(x)]
    return []


def dot_flops(jaxpr) -> int:
    """2 x output elements x contracted size of every dot_general, less
    the x . x ones (both operands one variable: the RMS norms' sums of
    squares, which the port computes elementwise and its counter, like
    ``torch.utils.flop_counter``, does not count)."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and \
                eqn.invars[0] is not eqn.invars[1]:
            (lc, _), _ = eqn.params["dimension_numbers"]
            a = eqn.invars[0].aval.shape
            k = math.prod(a[i] for i in lc)
            total += 2 * math.prod(eqn.outvars[0].aval.shape) * k
        times = eqn.params.get("length", 1) if \
            eqn.primitive.name == "scan" else 1
        for v in eqn.params.values():
            for sub in _jaxprs(v):
                total += times * dot_flops(sub)
    return total


def _config(arch):
    from repro.configs import registry
    return dataclasses.replace(registry.reduced_config(arch),
                               scan_layers=False)


def _abstract_params(cfg):
    from repro.common.param import unbox
    from repro.models import lm
    return jax.eval_shape(lambda k: unbox(lm.init_lm(k, cfg))[0],
                          jax.random.PRNGKey(0))


def prefill_flops(arch) -> int:
    from repro.models import lm
    from repro.parallel.api import cast_params_for_compute
    cfg = _config(arch)
    b, s = PREFILL
    params = _abstract_params(cfg)
    cache = jax.eval_shape(lambda: lm.init_cache(cfg, b, s))
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}

    def step(p, batch, cache):
        return lm.prefill(cast_params_for_compute(p, cfg.adtype), cfg,
                          batch, cache)
    return dot_flops(jax.make_jaxpr(step)(params, batch, cache).jaxpr)


def train_flops(arch) -> int:
    from repro.models import lm
    from repro.parallel.api import cast_params_for_compute
    cfg = _config(arch)
    b, s = TRAIN
    params = _abstract_params(cfg)
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}

    def loss(p, batch):
        return lm.loss_fn(cast_params_for_compute(p, cfg.adtype), cfg,
                          batch)[0]
    return dot_flops(jax.make_jaxpr(jax.value_and_grad(loss))(
        params, batch).jaxpr)


def argument_bytes(arch) -> int:
    from repro.common.partitioning import DEFAULT_RULES
    from repro.parallel import api
    from repro.train import optim
    from repro.configs import registry
    cfg = registry.reduced_config(arch)
    b, s = TRAIN
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    specs = {"batch": {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}}
    with mesh:
        step, _ = api.make_train_step(cfg, mesh, DEFAULT_RULES,
                                      example_batch=specs)
        pshapes, _ = api.param_specs(cfg, mesh, DEFAULT_RULES)
        state = {"params": pshapes,
                 "opt": jax.eval_shape(optim.adam_init, pshapes)}
        compiled = step.lower(state, specs["batch"]).compile()
    return int(compiled.memory_analysis().argument_size_in_bytes)


def main(out_path):
    jax.devices()         # start JAX on 8 devices before the dry run's import
    from repro.launch import dryrun
    out = {"train_overrides": {f"{a}|{s}": v for (a, s), v in
                               dryrun.TRAIN_OVERRIDES.items()},
           "prefill_dot_flops": {a: prefill_flops(a) for a in PREFILL_ARCHS},
           "train_dot_flops": {TRAIN_FLOPS_ARCH: train_flops(
               TRAIN_FLOPS_ARCH)},
           "argument_bytes": {ARGS_ARCH: argument_bytes(ARGS_ARCH)},
           "prefill": PREFILL, "train": TRAIN}
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
