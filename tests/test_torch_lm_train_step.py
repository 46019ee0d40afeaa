"""The port's LM train step (``parallel/api.make_train_step``) against the
JAX package's on the CPU: six steps of h2o-danube-1.8b, olmoe-1b-7b,
mamba2-2.7b, jamba-v0.1-52b and whisper-base at ``reduced_config`` in f32
from the same params, on the JAX token stream's batches (whisper adds
frame embeddings), with ``TrainConfig``'s defaults (Adam lr 3e-4, b2
0.95, eps 1e-8, clip 1.0, 100 warmup steps). The JAX step runs on a
one-device mesh with Auto axes (ROADMAP C2). Each step's loss,
``grad_norm`` and ``ce`` within atol + rtol 1e-4.
"""
import pytest

from tests import torch_lm_parity as P
from tests.torch_lm_parity import one_torch_thread  # noqa: F401

ARCHS = ["h2o-danube-1.8b", "olmoe-1b-7b", "mamba2-2.7b",
         "jamba-v0.1-52b", "whisper-base"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    got, _ = P.port_train_curve(arch)
    P.assert_curves_close(got, P.jax_train_curve(arch))
