"""granite-4.0-h-small on the port against its plain reference
(``tests/torch_ref/granite_hybrid.py``, plain torch, no JAX and nothing of
the port), on the CPU at a small size: seeded random weights of the
reduced config (d=64, one whole period of 10 layers in the published
pattern, 16 experts top-4 with a shared expert). Logits, loss and every
gradient in f32; prefill then decode through the cache against the full
forward pass; dropless routing under a skewed router; the expert shares
adding up to the uncut layer; the counts the memory plan reads; the
launcher; the tensor-parallel path's refusal."""
import dataclasses
import math

import pytest
import torch

from repro_torch.common.param import KeyGen, count_params, tree_leaves, \
    unbox
from repro_torch.configs import registry
from repro_torch.launch import train as launch_train
from repro_torch.models import blocks, layers, lm, moe
from repro_torch.obs.trace import TRACER
from repro_torch.parallel import api
from repro_torch.train.optim import tree_map
from tests.torch_lm_f32 import f32_unembed
from tests.torch_ref import granite_hybrid as ref

ARCH = "granite-4.0-h-small"
B, S = 2, 32                # two rows of two SSD chunks of 16
# f32 on both sides, the same equations summed in other orders (the
# port's SSD chunk loop against the listing's segment sums, grouped
# products against the dense mask): ~1e-6 of the largest logit here, so
# 1e-5 leaves a tenfold margin and still fails a wrong scale or term
LOGIT_TOL = 1e-5
# the same, through the backward, where sums of many more terms meet:
# each leaf's gradient within 1e-4 of its largest element
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32_config(**changes):
    return dataclasses.replace(registry.reduced_config(ARCH),
                               act_dtype="float32", **changes)


def ref_config(cfg, first_expert=0):
    """The reference's config.json keys of a port config."""
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "rms_norm_eps": cfg.norm_eps,
        "mamba_n_heads": cfg.ssm.n_heads(cfg.d_model),
        "mamba_d_head": cfg.ssm.head_dim, "mamba_d_state": cfg.ssm.d_state,
        "mamba_n_groups": cfg.ssm.n_groups, "mamba_d_conv": cfg.ssm.d_conv,
        "mamba_chunk_size": cfg.ssm.chunk,
        "layer_types": ["attention" if cfg.layer_kind(l) == "attn"
                        else "mamba" for l in range(cfg.n_layers)],
        "experts_routed": cfg.moe.n_experts,
        "num_local_experts": cfg.n_experts_held(),
        "first_expert_held": first_expert,
        "num_experts_per_tok": cfg.moe.top_k,
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "attention_multiplier": cfg.attention_multiplier,
        "logits_scaling": cfg.logits_scaling,
        "router_aux_loss_coef": 0.01,
    }


def ref_params(params, cfg):
    """The port's params in the reference's layout (views)."""
    period = blocks.block_period(cfg)
    out = {"embedding": params["embedding"]["table"],
           "final_norm": params["final_norm"]["scale"], "layers": []}
    for l in range(cfg.n_layers):
        sub = params["blocks"][f"sub{l % period}"]
        i = l // period
        m = sub["moe"]
        lp = {"norm1": sub["norm1"]["scale"][i],
              "norm2": sub["norm2"]["scale"][i],
              "moe": {"router": m["router"][i], "w_gate": m["w_gate"][i],
                      "w_up": m["w_up"][i], "w_down": m["w_down"][i],
                      "shared": {k: v[i] for k, v in m["shared"].items()}}}
        if "ssm" in sub:
            s = sub["ssm"]
            lp["mamba"] = {"in_proj": s["w_in"][i], "conv_w": s["conv_w"][i],
                           "conv_b": s["conv_b"][i],
                           "dt_bias": s["dt_bias"][i],
                           "A_log": s["A_log"][i], "D": s["D"][i],
                           "norm": s["norm_scale"][i],
                           "out_proj": s["w_out"][i]}
        else:
            a = sub["attn"]
            d = cfg.d_model
            lp["attn"] = {"q": a["wq"][i].reshape(d, -1),
                          "k": a["wk"][i].reshape(d, -1),
                          "v": a["wv"][i].reshape(d, -1),
                          "o": a["wo"][i].reshape(-1, d)}
        out["layers"].append(lp)
    return out


def params_of(cfg, seed=3):
    """f32 params with every leaf made random (the init's zero biases and
    unit norms would hide a wrong term)."""
    p = api.init_params(cfg, seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 100)
    for leaf in tree_leaves(p):
        if leaf.ndim <= 2 and leaf.shape[-1] != cfg.vocab_size:
            with torch.no_grad():
                leaf.mul_(1.0 + 0.2 * torch.randn(leaf.shape, generator=gen))
    return p


def tokens(cfg, seed=5, s=S):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (B, s + 1), generator=g)
    return ids[:, :-1], ids[:, 1:]


def test_config_is_published_and_the_ten_stay():
    cfg = registry.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.vocab_size) == (40, 4096, 32, 8, 128, 100352)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert,
            cfg.shared_expert_width) == (72, 10, 768, 1536)
    s = cfg.ssm
    assert (s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.n_groups,
            s.d_conv, s.chunk) == (128, 64, 128, 1, 4, 256)
    assert [l for l in range(40) if cfg.layer_kind(l) == "attn"] == \
        [5, 15, 25, 35]
    assert all(cfg.ffn_kind(l) == "moe" for l in range(40))
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.attention_multiplier, cfg.logits_scaling) == \
        (12.0, 0.22, 1 / 128, 16.0)
    assert not cfg.use_rope and cfg.tie_embeddings and cfg.norm_eps == 1e-5
    assert ARCH not in registry.list_archs() and \
        len(registry.list_archs()) == 10
    for arch in registry.list_archs():
        assert registry.get_config(arch).port_settings() == ()


def test_counts_of_the_cut_config_by_hand():
    """One chip's share, 10 layers and 9 of 72 experts held: 9 Mamba-2
    layers of 206.4M, one attention layer of 146.0M, the 411.0M tied
    embedding."""
    cfg = dataclasses.replace(registry.get_config(ARCH), n_layers=10,
                              experts_held=9)
    d, v, di, nh = 4096, 100352, 8192, 128
    conv = di + 2 * 128
    mamba = d * (2 * di + 2 * 128 + nh) + 4 * conv + conv + 3 * nh + di \
        + di * d
    attn = 2 * d * d + 2 * d * 1024
    experts = d * 72 + 9 * 3 * d * 768 + 3 * d * 1536
    norms = 2 * d
    assert mamba + experts + norms == 206_399_104
    assert attn + experts + norms == 146_055_168
    total = 9 * (mamba + experts + norms) + attn + experts + norms + v * d \
        + d
    assert total == 2_414_692_992
    tree = unbox(lm.init_lm(KeyGen(0, "meta"), cfg))[0]
    assert count_params(tree) == total
    # the config's count leaves out the conv bias, dt_bias, the gated
    # norm's scale and the final norm, as the JAX twins' count does
    assert cfg.param_count() == total - 9 * (conv + nh + di) - d
    # f32 params, gradients, mu and nu, and the bf16 compute copy of every
    # leaf of two or more dimensions (all but the final norm)
    assert api.train_state_bytes(cfg) == 16 * total + 2 * (total - d)
    # a token's active params: on average top_k * 9 / 72 = 1.25 held picks
    full_experts = 9 * 3 * d * 768
    assert cfg.active_param_count() == int(
        cfg.param_count() - 10 * (9 - 1.25) * full_experts / 9)


def test_logits_and_loss_match_the_reference():
    cfg = f32_config()
    p = params_of(cfg)
    toks, labels = tokens(cfg)
    rc = ref_config(cfg)
    with f32_unembed():
        got, _ = lm.forward(p, cfg, {"tokens": toks})
        loss, _ = lm.loss_fn(p, cfg, {"tokens": toks, "labels": labels})
    rp = ref_params(p, cfg)
    want = ref.logits(rp, rc, toks)
    assert (got - want).abs().max() <= LOGIT_TOL * want.abs().max()
    want_loss = ref.loss(rp, rc, toks, labels)
    assert abs(float(loss) - float(want_loss)) <= LOGIT_TOL * \
        abs(float(want_loss))


def test_every_gradient_matches_the_reference():
    cfg = f32_config()
    p = params_of(cfg)
    toks, labels = tokens(cfg, seed=6)
    pv = tree_map(lambda l: l.detach().requires_grad_(True), p)
    leaves = tree_leaves(pv)
    # the backward recomputes the CE chunks: inside the f32 unembedding too
    with f32_unembed():
        loss, _ = lm.loss_fn(pv, cfg, {"tokens": toks, "labels": labels})
        got = torch.autograd.grad(loss, leaves)
    rp = ref_params(pv, cfg)
    want = torch.autograd.grad(ref.loss(rp, ref_config(cfg), toks, labels),
                               leaves)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= GRAD_TOL * w.abs().max(), w.shape


def test_prefill_then_decode_match_the_full_forward():
    """The cache path (Mamba-2 states and the KV cache side by side) with
    the multipliers: prefill 16 tokens, decode 8, each step's logits
    against the reference's full forward at that position."""
    cfg = f32_config()
    p = params_of(cfg, seed=4)
    toks, _ = tokens(cfg, seed=8, s=24)
    want = ref.logits(ref_params(p, cfg), ref_config(cfg), toks)
    cache = lm.init_cache(cfg, B, 24, device="cpu")
    with f32_unembed(), torch.no_grad():
        got, cache = lm.prefill(p, cfg, {"tokens": toks[:, :16]}, cache)
        steps = [got]
        for pos in range(16, 23):
            got, cache = lm.decode_step(p, cfg, toks[:, pos:pos + 1], pos,
                                        cache)
            steps.append(got)
    got = torch.stack(steps, dim=1)
    want = want[:, 15:23]
    assert (got - want).abs().max() <= LOGIT_TOL * want.abs().max()


def _moe_inputs(cfg, n=96, seed=9):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((1, n, cfg.d_model), generator=g)
    logits = torch.randn((n, cfg.moe.n_experts), generator=g)
    return x, logits


def _layer_ref(mp, cfg, x, logits, first=0, held=None):
    """The reference's expert layer on given router logits (the dense
    mask of ``ref.experts``, its router swapped for the logits)."""
    rc = ref_config(cfg, first)
    rc["num_local_experts"] = held or cfg.n_experts_held()
    probs = torch.softmax(logits, -1)
    top, picks = torch.topk(probs, cfg.moe.top_k, -1)
    gates = torch.zeros_like(probs).scatter(-1, picks,
                                            top / top.sum(-1, keepdim=True))
    h = x[0]
    y = torch.zeros_like(h)
    for j in range(rc["num_local_experts"]):
        out = ref.swiglu(h, mp["w_gate"][j], mp["w_up"][j], mp["w_down"][j])
        y = y + gates[:, first + j, None] * out
    return y


def test_no_assignment_dropped_under_a_skewed_router():
    """Nine tokens in ten pick expert 0: the capacity path of the other
    archs drops past 1.25 times the fair share; the dropless path runs
    every assignment and equals the dense reference."""
    cfg = f32_config()
    mp = unbox(moe.init_moe(KeyGen(1, "cpu"), cfg))[0]
    x, logits = _moe_inputs(cfg)
    logits[: 9 * logits.shape[0] // 10, 0] += 20.0
    y, aux = moe.apply_moe({k: v for k, v in mp.items() if k != "shared"},
                           cfg, x, logits=logits)
    assert int(aux["moe_dropped"]) == 0
    assert int(aux["moe_max_load"]) >= 9 * x.shape[1] // 10
    want = _layer_ref(mp, cfg, x, logits)
    assert (y[0] - want).abs().max() <= LOGIT_TOL * want.abs().max()
    capped = dataclasses.replace(cfg, moe_dropless=False)
    _, aux = moe.apply_moe({k: v for k, v in mp.items() if k != "shared"},
                           capped, x, logits=logits)
    assert float(aux["moe_drop_frac"]) > 0.1


def test_eight_expert_shares_add_up_to_the_uncut_layer():
    """Eight devices of two experts each: their partial outputs, plus the
    shared expert counted once, add up to the whole layer of the uncut
    reference (16 experts held)."""
    cfg = f32_config()
    mp = unbox(moe.init_moe(KeyGen(2, "cpu"), cfg))[0]
    x, logits = _moe_inputs(cfg, seed=10)
    share_cfg = dataclasses.replace(cfg, experts_held=2)
    total = torch.zeros_like(x)
    for r in range(8):
        part = {"router": mp["router"],
                **{k: mp[k][2 * r:2 * r + 2]
                   for k in ("w_gate", "w_up", "w_down")}}
        y, aux = moe.apply_moe(part, share_cfg, x, logits=logits,
                               first_expert=2 * r)
        assert int(aux["moe_dropped"]) == 0
        total = total + y
    total = total + layers.swiglu(mp["shared"], x)
    want = _layer_ref(mp, cfg, x, logits) + ref.swiglu(x[0],
                                                         **mp["shared"])
    assert (total[0] - want).abs().max() <= LOGIT_TOL * want.abs().max()
    whole, _ = moe.apply_moe(mp, cfg, x, logits=logits)
    assert (whole[0] - want).abs().max() <= LOGIT_TOL * want.abs().max()


def test_the_reference_scan_is_the_recurrence():
    """The reference's chunked SSD listing against the plain per-step
    recurrence h_t = exp(dt A) h_{t-1} + dt B x_t, y_t = C h_t."""
    g = torch.Generator().manual_seed(11)
    b, s, h, p, n = 2, 12, 3, 4, 5
    x = torch.randn((b, s, h, p), generator=g, dtype=torch.float64)
    dt = torch.rand((b, s, h), generator=g, dtype=torch.float64)
    a = -torch.rand(h, generator=g, dtype=torch.float64) * 2
    bb = torch.randn((b, s, h, n), generator=g, dtype=torch.float64)
    cc = torch.randn((b, s, h, n), generator=g, dtype=torch.float64)
    y = ref.ssd(x * dt[..., None], a * dt, bb, cc, chunk=4)
    state = torch.zeros((b, h, p, n), dtype=torch.float64)
    want = []
    for t in range(s):
        state = state * torch.exp(dt[:, t] * a)[..., None, None] + \
            (dt[:, t, :, None] * x[:, t])[..., None] * bb[:, t, :, None, :]
        want.append(torch.einsum("bhpn,bhn->bhp", state, cc[:, t]))
    assert torch.allclose(y, torch.stack(want, 1), atol=1e-12)


def test_phases_of_the_train_step():
    """While the tracer records them, a train step holds the ``forward``,
    ``backward`` and ``adam`` phases, a ``ssm`` phase for each of the nine
    Mamba-2 mixers and a ``moe`` phase for each of the ten expert layers
    in the forward, and its metrics row carries the MoE counters."""
    cfg = registry.reduced_config(ARCH)
    step, _ = api.build_train_step(cfg)
    state = api.make_train_state(api.init_params(cfg, 0, device="cpu"))
    toks, labels = tokens(cfg)
    TRACER.clear()
    TRACER.enable(phases=("forward", "backward", "adam", "ssm", "moe"))
    try:
        with TRACER.scope("cpu", step=0):
            state, metrics = step(state, {"tokens": toks, "labels": labels})
        phases = [e for e in TRACER.events() if e["cat"] == "phase"
                  and e["args"].get("step") == 0]
    finally:
        TRACER.disable()
        TRACER.clear()
    names = [e["name"] for e in phases]
    for name in ("forward", "backward", "adam"):
        assert names.count(name) == 1, (name, names)
    fwd = next(e for e in phases if e["name"] == "forward")

    def in_forward(name):
        return sum(1 for e in phases if e["name"] == name
                   and fwd["ts"] <= e["ts"] <= fwd["ts"] + fwd["dur"])
    assert (in_forward("ssm"), in_forward("moe")) == (9, 10)
    assert int(metrics["moe_dropped"]) == 0
    assert 0 < int(metrics["moe_max_load"]) <= B * S


def test_the_launcher_trains_it_on_the_cpu():
    losses = []
    launch_train.train_loop(registry.reduced_config(ARCH), steps=2,
                            seq_len=32, global_batch=2, chunk_steps=1,
                            device="cpu",
                            on_step=lambda s, l, st: losses.append(l))
    assert len(losses) == 2 and all(math.isfinite(l) for l in losses)
    assert abs(losses[0] - math.log(256)) < 0.5
    launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--steps", "2"])


def test_the_tensor_parallel_path_refuses_it():
    cfg = registry.reduced_config(ARCH)
    with pytest.raises(NotImplementedError, match="embedding_multiplier"):
        blocks.apply_block_tp(None, [], cfg, 0, [], None, False)
    with pytest.raises(NotImplementedError, match="moe_dropless"):
        blocks.ffn_tp(None, [], cfg, 0, [], False)


def test_the_benchmark_holds_the_same_reference():
    """``ngbench/reference/granite_hybrid.py`` is this reference, frozen
    for the benchmark's check: the two files are equal."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    assert (root / "ngbench" / "reference" / "granite_hybrid.py"
            ).read_bytes() == (root / "tests" / "torch_ref" /
                               "granite_hybrid.py").read_bytes()
