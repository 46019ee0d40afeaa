"""Checkpoints and elastic recovery of the LM sharding on meshes that
repeat the CPU: a sharded train state saves the mesh-independent files of
its gathered tree and restores onto another mesh bit for bit
(``checkpoint/store.restore(shardings=)``); ``runtime/elastic.recover``
in its LM form rebuilds the state on a smaller plan; the engine resumes a
sharded run from its checkpoint and replays the uninterrupted run."""
import dataclasses
import filecmp
import json

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.common.partitioning import DEFAULT_RULES, \
    specs_to_shardings
from repro_torch.configs import registry
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import api, sharded as sh
from repro_torch.runtime import elastic
from repro_torch.train import optim
from tests.torch_lm_parity import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
ARCH = "h2o-danube-1.8b"


def cpu_mesh(data, model):
    return Mesh(np.array([CPU] * (data * model), dtype=object).reshape(
        data, model), ("data", "model"))


def cfg_f32():
    return dataclasses.replace(registry.reduced_config(ARCH),
                               act_dtype="float32")


def trained_state(cfg, mesh, steps=1, batch=8):
    """A sharded train state after ``steps`` steps on ``mesh``."""
    state = api.make_train_state(api.init_params(cfg, 0, mesh,
                                                 DEFAULT_RULES))
    step, _ = api.make_train_step(cfg, mesh, DEFAULT_RULES)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, 17)))
        state, _ = step(state, {"tokens": toks})
    return state


def gathered(state):
    return sh.gather_tree(state, CPU)


def assert_trees_equal(a, b):
    fa, fb = store._flatten(a), store._flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), p
        else:
            assert x == y, p


def test_state_saved_on_4x2_restores_on_2x2_bit_for_bit(tmp_path):
    cfg = cfg_f32()
    state = trained_state(cfg, cpu_mesh(4, 2))
    whole = gathered(state)
    store.save(state, 1, tmp_path / "sharded")
    store.save(whole, 1, tmp_path / "whole")
    d1, d2 = tmp_path / "sharded" / "step_00000001", \
        tmp_path / "whole" / "step_00000001"
    m1 = json.loads((d1 / store.MANIFEST).read_text())
    assert m1 == json.loads((d2 / store.MANIFEST).read_text())
    for rec in m1["leaves"]:
        assert filecmp.cmp(d1 / rec["file"], d2 / rec["file"],
                           shallow=False)
    mesh = cpu_mesh(2, 2)
    shapes, specs = api.param_specs(cfg, mesh, DEFAULT_RULES)
    target = {"params": shapes,
              "opt": optim.AdamState(step=0, mu=shapes, nu=shapes)}
    got = store.restore(tmp_path / "sharded", target,
                        shardings=specs_to_shardings(
                            api.train_state_specs(specs), mesh))
    leaf = optim.tree_leaves(got["params"])[0]
    assert isinstance(leaf, sh.Sharded) and leaf.sharding.mesh is mesh
    assert_trees_equal(gathered(got), whole)
    # a sharded target restores by its own sharding
    again = store.restore(tmp_path / "sharded", state)
    assert_trees_equal(gathered(again), whole)
    ckpt = store.AsyncCheckpointer(tmp_path / "async")
    ckpt.save(state, 1)
    ckpt.wait()
    for rec in m1["leaves"]:
        assert filecmp.cmp(d1 / rec["file"], tmp_path / "async" /
                           "step_00000001" / rec["file"], shallow=False)


def test_lm_recover_onto_a_smaller_plan(tmp_path):
    """A state saved on (4, 1) recovers onto the (2, 1) plan that
    ``remesh_plan`` gives two survivors: every leaf bit-equal, sharded on
    the new mesh, and the rebuilt step (twice the micro-batches) takes one
    more step."""
    cfg = cfg_f32()
    state = trained_state(cfg, cpu_mesh(4, 1))
    store.save(state, 1, tmp_path)
    plan = elastic.remesh_plan(2, 4, 1)
    assert (plan.data, plan.model, plan.microbatch_multiplier) == (2, 1, 2)

    def make_step(c, mesh, rules):
        return api.make_train_step(c, mesh, rules, train_cfg=api.TrainConfig(
            num_microbatches=plan.microbatch_multiplier))[0]

    mesh, step_fn, got, step = elastic.recover(tmp_path, cfg, plan,
                                               make_step=make_step,
                                               devices=[CPU] * 2)
    assert step == 1 and mesh.shape == {"data": 2, "model": 1}
    assert all(l.sharding.mesh is mesh
               for l in optim.tree_leaves(got["params"]))
    assert_trees_equal(gathered(got), gathered(state))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 17)))
    got, m = step_fn(got, {"tokens": toks})
    assert got["opt"].step == 2 and torch.isfinite(m["loss"])


def test_sharded_train_loop_resumes_bit_for_bit(tmp_path):
    """``train_loop`` on a (2, 2) mesh (rows fed by the engine) stopped
    after its checkpoint at step 3 resumes at step 4, and its losses equal
    the uninterrupted run's exactly."""
    cfg = registry.reduced_config("olmoe-1b-7b")
    mesh = cpu_mesh(2, 2)
    kw = dict(seq_len=16, global_batch=4, chunk_steps=4, ckpt_every=4,
              device="cpu")
    _, full = ttrain.train_loop(cfg, mesh, steps=8, ckpt_dir=str(
        tmp_path / "a"), **kw)
    _, first = ttrain.train_loop(cfg, mesh, steps=4, ckpt_dir=str(
        tmp_path / "b"), **kw)
    state, rest = ttrain.train_loop(cfg, mesh, steps=8, ckpt_dir=str(
        tmp_path / "b"), **kw)
    assert first + rest == full
    assert isinstance(optim.tree_leaves(state["params"])[0], sh.Sharded)
