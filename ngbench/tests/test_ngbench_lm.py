"""The language-model training kind (``kinds/lm_train.py``) on the CPU at
a tiny size: a whole run reports its numbers and comes out correct, each
control of the check (the shared expert left out, a held expert's picks
left out, the residual stream in float8) fails it, and so does a dropped
assignment; the counted FLOPs of one layer of each kind by hand. The
tiny copy keeps granite's structure (one period of 10 layers, attention
at 5, a shared expert, dropless routing over a held share of the experts)
at laptop widths, in f32 activations: the program's own gaps are then
round-off, and each control's stands out."""
import json
import time

import pytest
import torch

from ngbench import bench, lm_counts, spec
from ngbench.tests.tiny import make_copy
import repro_torch.models.moe as pmoe

CELL = "granite_4_0_h_small.train_8k_seq"
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "attention_multiplier": 0.0625,
        "mamba_n_heads": 16, "mamba_d_head": 8, "mamba_d_state": 16,
        "mamba_chunk_size": 16, "intermediate_size": 32,
        "shared_intermediate_size": 48, "vocab_size": 256,
        "experts_routed": 16, "num_local_experts": 4,
        "num_experts_per_tok": 4}


@pytest.fixture(scope="module")
def lm_tiny(tmp_path_factory):
    """The tiny copy with granite cut to laptop widths and two rows of 32
    tokens a step."""
    here = make_copy(tmp_path_factory.mktemp("lm_tiny"))
    path = here / "configs" / "granite_4_0_h_small.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY)
    path.write_text(json.dumps(cfg))
    path = here / "traffic" / "train_8k_seq.json"
    mix = json.loads(path.read_text())
    mix.update(rows=2, seq_len=32)
    path.write_text(json.dumps(mix))
    path = here / "workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl["train"]["act_dtype"] = "float32"
    path.write_text(json.dumps(wl))
    return here


def _run(here):
    return bench.run_cell(CELL, 2**31 + 41, 2.0, False, time.perf_counter(),
                          device="cpu", here=here)


def test_a_tiny_run_reports_its_numbers(lm_tiny):
    r = _run(lm_tiny)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_step_ms", "setup_s"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["moe_dropped"] == {"value": 0.0, "limit": 0}
    assert set(r["checks"]) == {"loss_gap", "grad_norm_gap",
                                "update_norm_gap", "update_norm_gap_worst",
                                "moe_dropped"}
    assert r["numbers"]["moe_max_load"] > 0


def test_each_control_fails_where_the_program_passes(lm_tiny):
    from ngbench import control, program
    cell = spec.find_cell(CELL, lm_tiny)
    out = {side: (numbers, ok) for side, numbers, ok, _ in control.readings(
        cell, 7, torch.device("cpu"), program, 1.0, True, here=lm_tiny)}
    assert set(out) == {"program", "control_no_shared",
                        "control_drop_expert", "control_fp8"}
    assert out["program"][1], out["program"][0]
    for side in ("control_no_shared", "control_drop_expert", "control_fp8"):
        assert not out[side][1], (side, out[side][0])


def test_a_dropped_assignment_fails(lm_tiny, monkeypatch):
    real = pmoe.dropless_experts

    def dropping(*a, **k):
        y, aux = real(*a, **k)
        return y, {**aux, "moe_dropped": aux["moe_dropped"] + 1}
    monkeypatch.setattr(pmoe, "dropless_experts", dropping)
    r = _run(lm_tiny)
    assert not r["correct"]
    assert r["checks"]["moe_dropped"]["value"] > 0


def test_counts_by_hand():
    """One layer of each kind at granite's published widths, 8k tokens."""
    cfg = json.loads((spec.HERE / "configs" /
                      "granite_4_0_h_small.json").read_text())
    d, di, v = 4096, 8192, 100352
    ssd = 2 * 256 * 128 + 2 * 256 * 8192 + 4 * 8192 * 128
    assert lm_counts.mamba(cfg) == 2 * d * 16768 + 2 * 4 * 8448 + ssd \
        + 2 * di * d
    assert lm_counts.attention(cfg, 8192) == \
        2 * d * (2 * 4096 + 2 * 1024) + 4 * 4096 * 32 * 128
    assert lm_counts.experts(cfg) == 2 * d * 72 + 1.25 * 6 * d * 768 \
        + 6 * d * 1536
    assert lm_counts.logits(cfg) == 2 * d * v
    per = lm_counts.forward_per_token(cfg, 8192)
    assert per["mamba"] == 9 * lm_counts.mamba(cfg)
    assert per["experts"] == 10 * lm_counts.experts(cfg)
    # a step of 4 x 8,192 tokens: about 3.5 GFLOP a token forward
    flops = lm_counts.train_step_flops(cfg, 4, 8192)
    assert flops == 3 * 4 * 8192 * sum(per.values())
    assert 3.4e9 < sum(per.values()) < 3.6e9


def test_token_batches_repeat_from_the_seed_and_step(lm_tiny):
    cell = spec.find_cell(CELL, lm_tiny)
    gen = spec.generator(cell, lm_tiny)
    cpu = torch.device("cpu")
    a = gen.make(cell.traffic, 2**31 + 3, cpu, 256)
    b = gen.make(cell.traffic, 2**31 + 3, cpu, 256)
    c = gen.make(cell.traffic, 2**31 + 4, cpu, 256)
    for step in (0, 1, 7):
        for k in ("tokens", "labels"):
            assert torch.equal(a(step)[k], b(step)[k])
        assert not torch.equal(a(step)["tokens"], c(step)["tokens"])
    x = a(0)
    assert x["tokens"].shape == x["labels"].shape == (2, 32)
    assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert not torch.equal(a(0)["tokens"], a(1)["tokens"])
    assert 0 <= int(x["tokens"].min()) and int(x["tokens"].max()) < 256
