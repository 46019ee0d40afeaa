"""The LM port's dense and VLM decoders against the JAX package, end to
end on the CPU: yi-6b, qwen2-7b (QKV bias), qwen3-32b (qk-norm),
h2o-danube-1.8b (sliding window, ring cache) and qwen2-vl-72b (patch
embeddings, M-RoPE positions), each at ``reduced_config`` in f32 on the
JAX package's own params (``from_jax_params``): ``forward``, ``loss_fn``,
``prefill`` (logits and cache) and 8 steps of ``decode_step`` (logits and
cache) within atol + rtol 1e-4 (``tests/torch_lm_parity.py`` says how
the bf16 unembedding is handled). The JAX side runs once per arch.
"""
import pytest

from tests import torch_lm_parity as P

ARCHS = ["yi-6b", "qwen2-7b", "qwen3-32b", "h2o-danube-1.8b",
         "qwen2-vl-72b"]


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
