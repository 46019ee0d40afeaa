"""The LM port's training backward against ``jax.value_and_grad`` on the
CPU, for the other families: olmoe-1b-7b and qwen3-moe-30b-a3b (the
grouped capacity dispatch, drops included, and the MoE aux loss),
jamba-v0.1-52b (hybrid SSM + attention + MoE), mamba2-2.7b (``ssd_chunked``
over 1 chunk of 16 and the causal conv) and whisper-base (encoder-decoder,
cross attention): at ``reduced_config`` in f32 on the JAX package's
params, the loss, its aux and every gradient leaf within atol + rtol
1e-4, under each block recompute policy against the same JAX gradients
(``tests/torch_lm_parity.py``).
"""
import dataclasses

import jax
import pytest

from repro.models import lm as jlm
from repro_torch.train import loop
from tests import torch_lm_parity as P
from tests.torch_lm_parity import one_torch_thread  # noqa: F401

ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
         "mamba2-2.7b", "whisper-base"]


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch, remat):
    P.check_grads(arch, remat)


def test_ssd_backward_over_chunks_matches_jax():
    """mamba2 with SSD chunks of 4 (S=16: 4 chunks, the inter-chunk state
    recurrence in the backward) against JAX's at the same chunk."""
    jcfg, _ = P.train_configs("mamba2-2.7b")
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm,
                                                             chunk=4))
    tssm = P.train_configs("mamba2-2.7b")[1].ssm
    cfg, mod, params = P.port_train_params(
        "mamba2-2.7b", ssm=dataclasses.replace(tssm, chunk=4))
    inp = P.inputs(cfg)
    with P.f32_unembed():
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(
            P.jax_params("mamba2-2.7b"), P.jax_batch(jcfg, inp))
        (loss, _), grads = loop.value_and_grad(
            lambda p, b: mod.loss_fn(p, cfg, b), params,
            P.torch_batch(cfg, inp), has_aux=True)
    P.assert_close(loss, float(jl), "loss")
    P.assert_tree_close(grads, P._np(jg), path="grad")


def test_ssd_backward_is_finite_where_the_segment_exp_overflows():
    """With dt grown so that the unused segment sums above the diagonal
    overflow ``exp`` (dt * |A| * chunk > 88), the forward still equals
    JAX's and every gradient is finite (JAX's exp-then-select backward is
    NaN there: 0 * inf)."""
    import torch
    from repro_torch.models import ssm
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 1, 16, 4, 8, 16
    x = torch.randn((b, s, h, p), generator=g, requires_grad=True)
    dt = torch.full((b, s, h), 8.0, requires_grad=True)
    a = -torch.linspace(1.0, 16.0, h)
    bb = torch.randn((b, s, 1, n), generator=g, requires_grad=True)
    cc = torch.randn((b, s, 1, n), generator=g, requires_grad=True)
    y, _ = ssm.ssd_chunked(x, dt, a, bb, cc, chunk=16)
    assert torch.isfinite(y).all()
    grads = torch.autograd.grad(y.square().sum(), (x, dt, bb, cc))
    assert all(torch.isfinite(gr).all() for gr in grads)
