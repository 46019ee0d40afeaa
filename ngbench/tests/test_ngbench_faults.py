"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have. The tests pass the device as the
CPU (no look for a card) and drive the rest of a run at a tiny size."""
import time

import pytest
import torch

from ngbench import bench
import repro_torch.core.pipeline as ppipe
import repro_torch.core.train as ptrain
import repro_torch.kernels.ray_march.ops as rm_ops
import repro_torch.train.optim as poptim


def _run(tiny, name):
    return bench.run_cell(name, 2**31 + 29, 5.0, False, time.perf_counter(),
                          device="cpu", here=tiny)


@pytest.mark.parametrize("name", ["nerf_hash.frames_720p",
                                  "nerf_hash.frames_720p_culled"])
def test_an_altered_pixel_fails(tiny, monkeypatch, name):
    real = rm_ops.composite

    def altered(rgb, sigma, dts):
        pixel, opacity = real(rgb, sigma, dts)
        pixel = pixel.clone()
        pixel[0, 0] += 0.01
        return pixel, opacity
    monkeypatch.setattr(rm_ops, "composite", altered)
    r = _run(tiny, name)
    assert not r["correct"]
    assert r["checks"]["px_err_max"]["value"] > \
        r["checks"]["px_err_max"]["limit"]


def test_an_altered_nsdf_row_fails(tiny, monkeypatch):
    real = ppipe.shade_nsdf

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[: out.shape[0] // 8] = 1.0 - out[: out.shape[0] // 8]
        return out
    monkeypatch.setattr(ppipe, "shade_nsdf", altered)
    r = _run(tiny, "nsdf_hash.frames_720p")
    assert not r["correct"]


def test_a_step_that_leaves_the_state_unchanged_fails(tiny, monkeypatch):
    def unchanged(grads, state, params, cfg):
        return params, state, {"lr": cfg.lr}
    monkeypatch.setattr(poptim, "adam_update", unchanged)
    r = _run(tiny, "nerf_hash.train_32k_rays")
    assert not r["correct"]
    assert r["checks"]["update_norm_gap"]["value"] > 0.5


def test_half_of_the_batch_left_out_fails(tiny, monkeypatch):
    real = ptrain.field_loss

    def half(params, cfg, batch, **kw):
        n = batch["origins"].shape[0] // 2
        return real(params, cfg, {k: v[:n] for k, v in batch.items()}, **kw)
    monkeypatch.setattr(ptrain, "field_loss", half)
    r = _run(tiny, "nerf_hash.train_32k_rays")
    assert not r["correct"]
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("name", ["nerf_hash.frames_720p",
                                  "nsdf_hash.frames_720p",
                                  "nerf_hash.frames_720p_culled",
                                  "nerf_hash.train_32k_rays"])
def test_the_tf32_control_fails_where_the_program_passes(tiny, name):
    """The control at a size a test run holds, judged as a run is judged
    (``bench.limits``, ``bench.passes``) against the cell's own limits:
    the program comes out correct, the reference with TF32 products in
    the program's place does not, nor does a training cell's half batch."""
    from ngbench import control, program, spec
    cell = spec.find_cell(name, tiny)
    out = {side: (numbers, ok) for side, numbers, ok, _ in control.readings(
        cell, 7, torch.device("cpu"), program, 1.0, True, here=tiny)}
    numbers, ok = out["program"]
    assert ok, numbers
    assert not out["control_tf32"][1], out["control_tf32"][0]
    if cell.kind == "train":
        assert not out["fault_half_batch"][1]
