"""repro_torch's ``train/compression.py`` against the JAX package's, on the
CPU: ``compress_topk`` and ``compress_int8`` equal JAX's bit for bit on the
same gradient and error feedback (the same threshold, the shared int8
codec), and mirrors of ``tests/test_compression.py``: the error-feedback
invariant, int8's error bound, the codec shared with field quantization,
conservation of mass and ``apply_inline`` on a tree.

Tolerances: top-k's ``kept + efb_new`` is ``g + efb_old`` exactly (kept
entries are copied, the rest moves whole); int8's invariant holds to f32
rounding of one subtraction (1e-6 at these magnitudes), its error within
half a code step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as jcomp
from repro_torch.quant import qtypes
from repro_torch.train import compression as comp


def _pair(seed, shape, efb_scale=0.1):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=shape).astype(np.float32)
    e = (rng.normal(size=shape) * efb_scale).astype(np.float32)
    return g, e


@pytest.mark.parametrize("shape,frac", [
    ((256,), 0.05), ((8,), 0.25), ((2, 1024, 2), 0.05), ((64, 3), 0.3),
    ((16, 4096, 2), 0.01), ((5,), 1e-6)])
def test_topk_matches_jax_bitwise(shape, frac):
    g, e = _pair(sum(shape), shape)
    kj, ej = jcomp.compress_topk(jnp.asarray(g), jnp.asarray(e), frac)
    kt, et = comp.compress_topk(torch.from_numpy(g), torch.from_numpy(e),
                                frac)
    assert np.array_equal(kt.numpy(), np.asarray(kj))
    assert np.array_equal(et.numpy(), np.asarray(ej))


def test_topk_keeps_ties_as_jax():
    """Entries tied with the k-th largest magnitude are all kept."""
    g = np.array([3.0, -3.0, 1.0, 3.0, 0.5, -2.0, 3.0, 0.1], np.float32)
    mask = comp.topk_mask(torch.from_numpy(g), 0.25)        # k = 2
    assert mask.numpy().tolist() == np.asarray(
        jcomp.topk_mask(jnp.asarray(g), 0.25)).tolist()
    assert int(mask.sum()) == 4


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("shape", [(128,), (64, 3), (4, 512, 2)])
def test_int8_matches_jax_bitwise(seed, shape):
    g, e = _pair(seed, shape, efb_scale=0.01)
    dj, ej = jcomp.compress_int8(jnp.asarray(g * 2.0), jnp.asarray(e))
    dt, et = comp.compress_int8(torch.from_numpy(g * 2.0),
                                torch.from_numpy(e))
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert np.array_equal(et.numpy(), np.asarray(ej))


def test_topk_keeps_largest():
    g = torch.tensor([0.1, -5.0, 0.3, 4.0, -0.2, 0.05, 2.0, -1.0])
    kept, err = comp.compress_topk(g, torch.zeros_like(g), 0.25)
    assert set(torch.nonzero(kept)[:, 0].tolist()) == {1, 3}
    assert torch.equal(kept + err, g)


@pytest.mark.parametrize("frac", [0.05, 0.5])
def test_topk_error_feedback_invariant(frac):
    """kept + new_err == grad + old_err, exactly: nothing is lost."""
    g, e = _pair(0, (256,))
    g, e = torch.from_numpy(g), torch.from_numpy(e)
    kept, new_e = comp.compress_topk(g, e, frac)
    assert torch.equal(kept + new_e, g + e)
    assert int((kept != 0).sum()) == max(1, int(256 * frac))


@pytest.mark.parametrize("seed", range(8))
def test_int8_quantization_bounded_error(seed):
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=128).astype(np.float32))
    deq, err = comp.compress_int8(g, torch.zeros_like(g))
    scale = float(g.abs().max()) / 127.0
    assert float(err.abs().max()) <= scale * 0.5 + 1e-6
    np.testing.assert_allclose((deq + err).numpy(), g.numpy(), atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_int8_wire_codec_matches_field_codec(seed):
    """compress_int8 is the port's field codec: the wire tensor is
    qtypes.quantize at the per-tensor abs-max scale and the dequant is
    qtypes.dequantize, bit for bit."""
    g = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(64, 3)).astype(np.float32)) * 2.0
    deq, err = comp.compress_int8(g, torch.zeros_like(g))
    scale = qtypes.absmax_scale(g, "int8")
    q = qtypes.quantize(g, scale, "int8")
    assert torch.equal(deq, qtypes.dequantize(q, scale))
    assert float(err.abs().max()) <= float(scale) * 0.5 + 1e-7


def test_error_feedback_conserves_total_mass():
    """sum(sent) + efb == n * g over any horizon (rtol 1e-5: 200 f32
    additions), and the dominant entry is sent at full rate."""
    g = torch.tensor([1.0, 0.1, 0.01, 0.001])
    efb = torch.zeros_like(g)
    sent = torch.zeros_like(g)
    n = 200
    for _ in range(n):
        kept, efb = comp.compress_topk(g, efb, 0.25)
        sent = sent + kept
    np.testing.assert_allclose((sent + efb).numpy(), g.numpy() * n,
                               rtol=1e-5)
    assert abs(float(sent[0]) / n - 1.0) <= 0.05


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_apply_inline_tree_matches_jax(scheme):
    """Two steps of apply_inline on a nested tree, the error feedback
    carried: the same sent gradients and feedback as JAX's, bit for bit."""
    rng = np.random.default_rng(1)
    grads = {"w": rng.normal(size=(32, 8)).astype(np.float32),
             "sub": {"b": rng.normal(size=(8,)).astype(np.float32)}}

    class TC:
        compression = scheme
        compression_topk = 0.1

    tg = {"w": torch.from_numpy(grads["w"]),
          "sub": {"b": torch.from_numpy(grads["sub"]["b"])}}
    jnew, jstate = jcomp.apply_inline(jax.tree.map(jnp.asarray, grads), {},
                                      TC)
    tnew, tstate = comp.apply_inline(tg, {}, TC)
    assert set(tstate["efb"]) == {"w", "sub"}
    jnew, jstate = jcomp.apply_inline(jax.tree.map(jnp.asarray, grads),
                                      jstate, TC)
    tnew, tstate = comp.apply_inline(tg, tstate, TC)
    for got, ref in ((tnew["w"], jnew["w"]),
                     (tnew["sub"]["b"], jnew["sub"]["b"]),
                     (tstate["efb"]["w"], jstate["efb"]["w"]),
                     (tstate["efb"]["sub"]["b"], jstate["efb"]["sub"]["b"])):
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_apply_inline_rejects_an_unknown_scheme():
    class TC:
        compression = "fp4"
        compression_topk = 0.1
    with pytest.raises(ValueError):
        comp.apply_inline({"w": torch.ones(4)}, {}, TC)
