"""The LM port's MoE, SSM, hybrid and encoder-decoder models against the JAX package, end to
end on the CPU: olmoe-1b-7b and qwen3-moe-30b-a3b (MoE, capacity drops
at the default factor), mamba2-2.7b (SSD), jamba-v0.1-52b (the hybrid
period: SSM, attention, MoE every other layer) and whisper-base
(encoder-decoder: ``encode`` and ``decode_train`` for ``forward``), each
at ``reduced_config`` in f32 on the JAX package's own params
(``from_jax_params``): ``forward``, ``loss_fn``,
``prefill`` (logits and cache) and 8 steps of ``decode_step`` (logits and
cache) within atol + rtol 1e-4 (``tests/torch_lm_parity.py`` says how
the bf16 unembedding is handled). The JAX side runs once per arch.
"""
import pytest

from tests import torch_lm_parity as P

ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b", "mamba2-2.7b",
         "jamba-v0.1-52b", "whisper-base"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    P.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    P.check_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    P.check_prefill(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    P.check_decode(arch)
