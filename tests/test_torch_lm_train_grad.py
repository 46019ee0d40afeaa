"""The LM port's training backward against ``jax.value_and_grad`` on the
CPU, for the dense and VLM decoders (yi-6b, qwen2-7b, qwen3-32b,
h2o-danube-1.8b, qwen2-vl-72b) at ``reduced_config`` in f32 on the JAX
package's params: the loss, its aux and every gradient leaf within atol +
rtol 1e-4, under each block recompute policy ("full", "dots", "none")
against the same JAX gradients. Attention runs chunked (4 query blocks)
and danube's window of 4 slices the keys, so their backward (each query
block recomputed) is covered. ``tests/torch_lm_parity.py`` holds the
oracles and says why the unembedding is widened to f32 on both sides.
"""
import pytest
import torch

from repro_torch.common.param import tree_map
from tests import torch_lm_parity as P
from tests.torch_lm_parity import one_torch_thread  # noqa: F401

ARCHS = ["yi-6b", "qwen2-7b", "qwen3-32b", "h2o-danube-1.8b",
         "qwen2-vl-72b"]
REMAT = ["full", "dots", "none"]


@pytest.mark.parametrize("remat", REMAT)
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch, remat):
    P.check_grads(arch, remat)


def _op_counts(remat):
    """aten.mm and aten.bmm calls of one loss and backward of reduced
    qwen2-7b under ``remat`` (attention unchunked: one bmm pair a
    block)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.train import loop

    counts = {"mm": 0, "bmm": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in counts:
                counts[name] += 1
            return func(*args, **(kwargs or {}))

    cfg, mod, params = P.port_train_params("qwen2-7b", remat=remat,
                                           attn_q_chunk=1024)
    batch = P.torch_batch(cfg, P.inputs(cfg))
    with P.f32_unembed(), Count():
        loop.value_and_grad(lambda p, b: mod.loss_fn(p, cfg, b)[0], params,
                            batch)
    return counts


def test_remat_policies_recompute_what_they_say():
    """"none" recomputes nothing; "dots" recomputes the batched products
    (attention's bmm) but saves the weight products (mm); "full"
    recomputes both."""
    none, dots, full = (_op_counts(r) for r in REMAT[::-1])
    assert dots["mm"] == none["mm"] < full["mm"]
    assert none["bmm"] < dots["bmm"] == full["bmm"]


def test_remat_full_keeps_only_block_inputs():
    """Under "full" the saved activations of a loss are fewer bytes than
    under "none" (the blocks' intermediates are dropped)."""
    def saved_bytes(remat):
        cfg, mod, params = P.port_train_params("qwen2-7b", remat=remat)
        batch = P.torch_batch(cfg, P.inputs(cfg))
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        views = tree_map(lambda a: a.detach().requires_grad_(True), params)
        with P.f32_unembed(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            mod.loss_fn(views, cfg, batch)
        return total[0]

    assert saved_bytes("full") < saved_bytes("none")
