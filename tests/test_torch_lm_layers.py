"""The LM port's layers, attention, MoE and SSD against the JAX package's
functions of the same name, on the same numpy inputs on the CPU.

f32 results are held to atol + rtol 1e-4 (most agree to 1e-6). bf16
norms, linear, embedding and MoE round in the same places as the JAX
functions and are held bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.common.param import unbox
from repro.configs import registry as jregistry
from repro.models import attention as jattn, layers as jlayers, \
    moe as jmoe, ssm as jssm
from repro_torch.common.param import KeyGen
from repro_torch.configs import registry as tregistry
from repro_torch.models import attention as tattn, layers as tlayers, \
    moe as tmoe, ssm as tssm

TOL = 1e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t if dtype is None else t.to(dtype)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _cfgs(arch, **kw):
    kw.setdefault("act_dtype", "float32")
    return (dataclasses.replace(jregistry.reduced_config(arch), **kw),
            dataclasses.replace(tregistry.reduced_config(arch), **kw))


# ---------------------------------------------------------------- norms
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "head_rmsnorm"])
def test_norms_match_jax(norm, dtype):
    rng = _rng()
    x = (rng.standard_normal((2, 5, 3, 48)) * 3 + 0.5).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = _t(x, getattr(torch, dtype))
    if norm == "rmsnorm":
        want = jlayers.rmsnorm({"scale": scale}, xj, 1e-6)
        got = tlayers.rmsnorm({"scale": _t(scale)}, xt, 1e-6)
    elif norm == "layernorm":
        want = jlayers.layernorm({"scale": scale, "bias": bias}, xj)
        got = tlayers.layernorm({"scale": _t(scale), "bias": _t(bias)}, xt)
    else:
        want = jlayers.head_rmsnorm(scale, xj, 1e-6)
        got = tlayers.head_rmsnorm(_t(scale), xt, 1e-6)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        _close(got, want)
    else:       # the same roundings in the same order: bit for bit
        np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------- RoPE
def test_rope_and_m_rope_match_jax():
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(tlayers.apply_rope(_t(x), _t(pos), theta),
               jlayers.apply_rope(x, pos, theta))
    pos3 = rng.integers(0, 300, (3, 2, 7)).astype(np.int32)
    want = jlayers.apply_m_rope(x, pos3, 1e6, (2, 3, 3))
    _close(tlayers.apply_m_rope(_t(x), _t(pos3), 1e6, (2, 3, 3)), want)
    # equal streams reduce M-RoPE to RoPE; distinct ones do not
    eq = np.broadcast_to(pos[None], (3, 2, 7)).copy()
    _close(tlayers.apply_m_rope(_t(x), _t(eq), 1e6, (2, 3, 3)),
           tlayers.apply_rope(_t(x), _t(pos), 1e6))
    assert float((tlayers.apply_m_rope(_t(x), _t(pos3), 1e6, (2, 3, 3))
                  - tlayers.apply_rope(_t(x), _t(pos3[0]), 1e6))
                 .abs().max()) > 1e-3


def test_sinusoidal_positions_match_jax():
    _close(tlayers.sinusoidal_positions(40, 24),
           jlayers.sinusoidal_positions(40, 24), tol=1e-5)


# ---------------------------------------------------------------- FFNs
def test_swiglu_and_tanh_gelu_mlp_match_jax():
    rng = _rng(2)
    d, f = 32, 48
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    sw = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for k, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                       ("w_down", (f, d)))}
    _close(tlayers.swiglu({k: _t(v) for k, v in sw.items()}, _t(x)),
           jlayers.swiglu(sw, x))
    ge = {"w_up": sw["w_up"], "w_down": sw["w_down"],
          "b_up": rng.standard_normal(f).astype(np.float32),
          "b_down": rng.standard_normal(d).astype(np.float32)}
    want = jlayers.gelu_mlp(ge, x)
    got = tlayers.gelu_mlp({k: _t(v) for k, v in ge.items()}, _t(x))
    # jax.nn.gelu is the tanh approximation, 1e-4 off the erf form at
    # |x| ~ 2: held at 1e-5, which f32 rounding meets and the erf misses
    _close(got, want, tol=1e-5)
    h = x @ ge["w_up"] + ge["b_up"]
    erf = torch.nn.functional.gelu(_t(h)) @ _t(ge["w_down"]) + _t(
        ge["b_down"])
    with pytest.raises(AssertionError):
        _close(erf, want, tol=1e-5)


def test_unembed_rounds_both_operands_to_bf16():
    """bf16 operands, f32 sums, f32 logits, in f32 and bf16 acts alike:
    equal to JAX's on the same inputs; widening without the rounding is
    visibly different."""
    rng = _rng(3)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    table = (rng.standard_normal((100, 64)) * 0.02).astype(np.float32)
    want = np.asarray(jlayers.unembed({"table": table}, x))
    got = tlayers.unembed({"table": _t(table)}, _t(x))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 100)
    _close(got, want, tol=1e-6)
    got_bf = tlayers.unembed({"table": _t(table, torch.bfloat16)},
                             _t(x, torch.bfloat16))
    _close(got_bf, want, tol=1e-6)
    assert float(np.abs(x @ table.T - want).max()) > 1e-4


def test_linear_matches_jax():
    rng = _rng(16)
    p = {"w": rng.standard_normal((12, 20)).astype(np.float32),
         "b": rng.standard_normal(20).astype(np.float32)}
    x = rng.standard_normal((3, 12)).astype(np.float32)
    pt = {k: _t(v) for k, v in p.items()}
    _close(tlayers.linear(pt, _t(x)), jlayers.linear(p, x))
    # bf16: one rounding of the f32-accumulated product, then a bf16 add
    got = tlayers.linear(pt, _t(x), act_dtype=torch.bfloat16)
    want = jlayers.linear({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_embed_matches_jax():
    rng = _rng(4)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 6)).astype(np.int32)
    want = jlayers.embed({"table": table}, ids, jnp.bfloat16)
    got = tlayers.embed({"table": _t(table)}, _t(ids), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(ml_dtypes.bfloat16).view(np.int16))


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("sq,sk,window,causal", [
    (8, 8, None, True), (8, 8, 4, True), (3, 10, None, True),
    (3, 10, 5, True), (6, 9, None, False)])
def test_causal_mask_matches_jax(sq, sk, window, causal):
    np.testing.assert_array_equal(
        tattn.causal_mask(sq, sk, window=window, causal=causal).numpy(),
        np.asarray(jattn.causal_mask(sq, sk, window=window, causal=causal)))


def _qkv(rng, b, sq, sk, h, kv, hd):
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kv, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kv, hd)).astype(np.float32))


@pytest.mark.parametrize("window,causal,q_chunk", [
    (None, True, 8), (None, False, 8), (12, True, 8), (12, True, 4),
    (40, True, 8)])
def test_chunked_attention_matches_jax_and_unchunked(window, causal,
                                                     q_chunk):
    """q-blocks of q_chunk rows (SWA: keys sliced to window + q_chunk from
    a clipped start when that is fewer than all); against the JAX
    function and against the port's one-block attention."""
    cj, ct = _cfgs("h2o-danube-1.8b", swa_window=window,
                   attn_q_chunk=q_chunk)
    q, k, v = _qkv(_rng(5), 2, 48, 48, 4, 2, 16)
    want = jattn._attend_maybe_chunked(q, k, v, cj, causal)
    got = tattn._attend_maybe_chunked(_t(q), _t(k), _t(v), ct, causal)
    _close(got, want)
    assert tattn.q_chunk(ct, 48) == q_chunk
    one = tattn._attend_maybe_chunked(
        _t(q), _t(k), _t(v), dataclasses.replace(ct, attn_q_chunk=None),
        causal)
    _close(got, one)


def test_kv_heads_are_not_repeated_and_the_output_is_equal():
    """The JAX function repeats 2 KV heads to attn_kv_pad_to=16 when the
    16 query heads divide by it (TPU sharding); the port attends grouped
    without the repeat: equal outputs, and with the repeat switched off
    in JAX too."""
    cj, _ = _cfgs("yi-6b", n_heads=16, n_kv_heads=2)
    assert cj.attn_kv_pad_to == 16
    q, k, v = _qkv(_rng(6), 2, 10, 10, 16, 2, 8)
    mask = np.asarray(jattn.causal_mask(10, 10))
    got = tattn._grouped_attend(_t(q), _t(k), _t(v), _t(mask))
    _close(got, jattn._grouped_attend(q, k, v, mask, cj))
    _close(got, jattn._grouped_attend(
        q, k, v, mask, dataclasses.replace(cj, attn_kv_pad_to=0)))


def test_fully_masked_row_is_uniform_not_nan():
    q, k, v = _qkv(_rng(7), 1, 1, 6, 4, 2, 8)
    mask = np.zeros((1, 1, 6), bool)
    got = tattn._grouped_attend(_t(q), _t(k), _t(v), _t(mask))
    assert torch.isfinite(got).all()
    _close(got, _t(v).mean(1, keepdim=True).repeat_interleave(2, 2))
    _close(got, jattn._grouped_attend(q, k, v, mask,
                                      _cfgs("yi-6b")[0]))


def _attn_params(cfg, seed):
    key = jax.random.PRNGKey(seed)
    pj = jax.tree.map(np.asarray, unbox(jattn.init_attention(key, cfg))[0])
    # non-zero biases, so the QKV bias path shows
    for k in ("bq", "bk", "bv"):
        if k in pj:
            pj[k] = _rng(seed).standard_normal(pj[k].shape).astype(
                np.float32)
    return pj, {k: _t(v) for k, v in pj.items()}


@pytest.mark.parametrize("s", [5, 8, 13])
def test_ring_cache_prefill_and_decode_match_jax(s):
    """Window 8, capacity 24 -> ring of 8 slots: a prompt shorter than,
    equal to and longer than the ring (padded with -1, or its trailing
    window rolled so slot = pos % 8), then 12 decode steps around the
    ring, masked by the stored slot positions."""
    cj, ct = _cfgs("h2o-danube-1.8b", swa_window=8, qkv_bias=True)
    pj, pt = _attn_params(cj, 8)
    rng = _rng(8)
    x = rng.standard_normal((2, s, cj.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    cache_j = jattn.init_kv_cache(cj, 2, 24, ring=True)
    cache_t = tattn.init_kv_cache(ct, 2, 24, ring=True)
    assert tuple(cache_t["k"].shape) == (2, 8, 2, 16)
    assert (cache_t["slot_pos"] == -1).all()
    yj, cache_j = jattn.prefill_into_cache(pj, cj, x, pos, cache_j)
    yt, cache_t = tattn.prefill_into_cache(pt, ct, _t(x), _t(pos.copy()),
                                           cache_t)
    _close(yt, yj)
    for k in ("k", "v", "slot_pos"):
        _close(cache_t[k], cache_j[k])
    for i in range(12):
        xd = rng.standard_normal((2, 1, cj.d_model)).astype(np.float32)
        yj, cache_j = jattn.decode_step_attn(pj, cj, xd, jnp.int32(s + i),
                                             cache_j)
        yt, cache_t = tattn.decode_step_attn(pt, ct, _t(xd), s + i, cache_t)
        _close(yt, yj)
        np.testing.assert_array_equal(cache_t["slot_pos"].numpy(),
                                      np.asarray(cache_j["slot_pos"]))
        _close(cache_t["k"], cache_j["k"])


# ------------------------------------------------------------------- SSD
def test_causal_conv_matches_jax():
    rng = _rng(9)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for st in (None, state):
        yj, sj = jssm._causal_conv(x, w, b, st)
        yt, s_t = tssm._causal_conv(_t(x), _t(w), _t(b),
                                    None if st is None else _t(st))
        _close(yt, yj)
        _close(s_t, sj)


def _ssd_inputs(seed, b=2, s=32, h=4, p=8, n=16, g=2):
    rng = _rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("chunk", [1, 8, 32])
def test_ssd_chunked_matches_jax_and_the_recurrence(chunk):
    """The chunked form against the JAX function, and against the
    token-by-token recurrence (two groups of two heads each)."""
    x, dt, A, B, C = _ssd_inputs(10)
    yj, sj = jssm.ssd_chunked(x, dt, A, B, C, chunk)
    yt, st = tssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(B), _t(C), chunk)
    _close(yt, yj)
    _close(st, sj)
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    state = np.zeros((b, h, p, B.shape[3]), np.float64)
    ys = []
    for t in range(s):
        decay = np.exp(dt[:, t] * A[None])
        Bt = np.repeat(B[:, t], rep, axis=1)
        Ct = np.repeat(C[:, t], rep, axis=1)
        state = state * decay[:, :, None, None] + \
            (dt[:, t][:, :, None] * x[:, t])[..., None] * Bt[:, :, None, :]
        ys.append(np.einsum("bhpn,bhn->bhp", state, Ct))
    _close(yt, np.stack(ys, 1), tol=1e-3)
    _close(st, state, tol=1e-3)


def test_ssd_overflowing_segments_give_no_nan():
    """Large dt*|A| over a chunk: exp of the upper triangle's segment sums
    overflows to inf and must be selected away, not multiplied by 0."""
    x, dt, A, B, C = _ssd_inputs(11, s=64)
    dt = dt * 40.0
    yt, st = tssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(B), _t(C), 64)
    assert torch.isfinite(yt).all() and torch.isfinite(st).all()
    yj, _ = jssm.ssd_chunked(x, dt, A, B, C, 64)
    _close(yt, yj, tol=1e-3)


@pytest.mark.parametrize("s", [16, 17])
def test_apply_ssm_and_decode_match_jax(s):
    """A whole Mamba-2 block (a prime length past the chunk of 16 runs
    chunk 1), then decode
    steps from its state, against the JAX functions."""
    cj, ct = _cfgs("mamba2-2.7b")
    pj = jax.tree.map(np.asarray, unbox(jssm.init_ssm(
        jax.random.PRNGKey(12), cj))[0])
    pt = {k: _t(v) for k, v in pj.items()}
    x = _rng(12).standard_normal((2, s, cj.d_model)).astype(np.float32)
    yj, cj_ = jssm.apply_ssm(pj, cj, x, return_state=True)
    yt, ct_ = tssm.apply_ssm(pt, ct, _t(x), return_state=True)
    _close(yt, yj)
    assert tssm.ssd_chunk(ct, s) == (16 if s == 16 else 1)
    cache_t = {k: v.clone() for k, v in ct_.items()}
    cache_j = cj_
    for i in range(3):
        xd = _rng(13 + i).standard_normal((2, 1, cj.d_model)).astype(
            np.float32)
        yj, cache_j = jssm.decode_step_ssm(pj, cj, xd, cache_j)
        yt, cache_t = tssm.decode_step_ssm(pt, ct, _t(xd), cache_t)
        _close(yt, yj)
        for k in cache_j:
            _close(cache_t[k], cache_j[k])


# -------------------------------------------------------------------- MoE
def test_apply_moe_with_drops_matches_jax():
    """olmoe's reduced MoE at the default capacity factor (1.25) on 64
    tokens: the same assignments dropped (the drop share is > 0 and equal),
    the same output and aux loss. No router tie: the top-k order is the
    same in both packages."""
    cj, ct = _cfgs("olmoe-1b-7b")
    assert cj.moe.capacity_factor == 1.25
    pj = jax.tree.map(np.asarray, unbox(jmoe.init_moe(
        jax.random.PRNGKey(14), cj))[0])
    pt = {k: _t(v) for k, v in pj.items()}
    x = _rng(14).standard_normal((2, 32, cj.d_model)).astype(np.float32)
    yj, auxj = jmoe.apply_moe(pj, cj, x)
    yt, auxt = tmoe.apply_moe(pt, ct, _t(x))
    probs = np.sort(np.asarray(jax.nn.softmax(x @ pj["router"], -1)), -1)
    k = cj.moe.top_k
    assert (np.diff(probs[..., -(k + 1):], axis=-1) > 0).all(), "a tie"
    assert float(auxj["moe_drop_frac"]) > 0
    assert float(auxt["moe_drop_frac"]) == float(auxj["moe_drop_frac"])
    _close(auxt["moe_aux_loss"], auxj["moe_aux_loss"])
    _close(yt, yj)
    assert tmoe.moe_group_size(ct.moe, 64) == jmoe.moe_group_size(cj.moe, 64)
    assert tmoe.moe_capacity(ct.moe, 64) == jmoe.moe_capacity(cj.moe, 64)


def test_moe_expert_silu_runs_in_f32_in_bf16():
    """bf16 acts: the port's MoE equals JAX's bit for bit (the expert SiLU
    widened to f32, then cast; the dense swiglu's stays bf16)."""
    cj, ct = _cfgs("qwen3-moe-30b-a3b", act_dtype="bfloat16")
    cj = dataclasses.replace(cj, moe=dataclasses.replace(
        cj.moe, capacity_factor=16.0))
    ct = dataclasses.replace(ct, moe=dataclasses.replace(
        ct.moe, capacity_factor=16.0))
    pj = unbox(jmoe.init_moe(jax.random.PRNGKey(15), cj))[0]
    pt = {k: _t(np.asarray(v)) for k, v in pj.items()}
    x = _rng(15).standard_normal((1, 8, cj.d_model)).astype(np.float32)
    yj, _ = jmoe.apply_moe(pj, cj, jnp.asarray(x, jnp.bfloat16))
    yt, aux = tmoe.apply_moe(pt, ct, _t(x, torch.bfloat16))
    assert yt.dtype == torch.bfloat16 and float(aux["moe_drop_frac"]) == 0
    np.testing.assert_array_equal(yt.float().numpy(),
                                  np.asarray(yj.astype(jnp.float32)))


def test_init_shapes_axes_and_distributions():
    """The port's own init: the JAX trees' shapes and logical axes; its
    draws follow the JAX distributions (not the same draws: another
    RNG) and are a function of the seed."""
    cj, ct = _cfgs("jamba-v0.1-52b")
    from repro.models import lm as jlm
    from repro_torch.common.param import unbox as tunbox
    from repro_torch.models import lm as tlm
    jshapes, jaxes = unbox(jax.eval_shape(
        lambda k: jlm.init_lm(k, cj), jax.random.PRNGKey(0)))
    tparams, taxes = tunbox(tlm.init_lm(KeyGen(0, "cpu"), ct))
    assert jax.tree.map(lambda s: tuple(s.shape), jshapes) == \
        jax.tree.map(lambda a: tuple(a.shape), tparams)
    assert jaxes == taxes
    again = tunbox(tlm.init_lm(KeyGen(0, "cpu"), ct))[0]
    emb = tparams["embedding"]["table"]
    assert torch.equal(emb, again["embedding"]["table"])
    assert abs(float(emb.std()) - 0.02) < 0.002
    w = tparams["blocks"]["sub4"]["attn"]["wq"]           # fan-in d_model
    assert abs(float(w.std()) * np.sqrt(ct.d_model) - 1.0) < 0.05
