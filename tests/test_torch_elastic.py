"""repro_torch's elastic re-mesh (``runtime/elastic.py``) against the JAX
package's, on the CPU: ``remesh_plan`` equal to JAX's on the same cases
and the same hypothesis draws, ``build_mesh``'s shapes, and a recovery:
a 4-shard run that loses a host (a ``FailureEvent`` from the health
stack) resumes on 2 shards with twice the micro-batches, from a restored
state equal to the saved one bit for bit, and its losses stay within 1e-6
of an uninterrupted 4-shard run's (the same global batches; the mean over
the shards is summed in another order).
"""
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.runtime import elastic as jelastic
from repro_torch.checkpoint import store
from repro_torch.core import fields as tfields
from repro_torch.core import train as ttrain
from repro_torch.launch.mesh import Mesh
from repro_torch.runtime import elastic
from repro_torch.runtime.health import FailureEvent, HeartbeatMonitor
from repro_torch.train import loop as tloop
from repro_torch.train import optim as toptim
from tests.test_torch_grad import _t_batch, jax_start

CPU = torch.device("cpu")
RESUME_TOL = 1e-6


def _same_plan(*args, **kw):
    got = elastic.remesh_plan(*args, **kw)
    want = jelastic.remesh_plan(*args, **kw)
    assert (got.data, got.model, got.microbatch_multiplier, got.chips) == (
        want.data, want.model, want.microbatch_multiplier, want.chips)
    return got


@pytest.mark.parametrize("n", [1, 2, 12, 36, 97, 192, 4096])
def test_divisors_match_jax(n):
    assert elastic._divisors_desc(n) == jelastic._divisors_desc(n)


def test_remesh_plan_prefers_same_tp():
    plan = _same_plan(surviving_chips=192, old_data=16, old_model=16)
    assert plan.model == 16 and plan.data == 12
    assert plan.microbatch_multiplier == 2


def test_remesh_plan_shrinks_tp_when_needed():
    plan = _same_plan(surviving_chips=24, old_data=4, old_model=16)
    assert plan.model in (8, 4, 2, 1) and 16 % plan.model == 0
    assert plan.chips <= 24


def test_remesh_plan_of_a_lost_host():
    """Two hosts of two devices each on a (4, 1) mesh; one is lost."""
    plan = _same_plan(2, 4, 1)
    assert (plan.data, plan.model, plan.microbatch_multiplier) == (2, 1, 2)
    assert _same_plan(4, 4, 2, max_model=1).model == 1
    for mod in (elastic, jelastic):
        with pytest.raises(ValueError, match="no valid mesh"):
            mod.remesh_plan(0, 4, 1)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 4096), st.sampled_from([1, 2, 4, 8, 16]),
       st.sampled_from([1, 2, 4, 8, 16]))
def test_remesh_plan_properties(survivors, old_data, old_model):
    plan = _same_plan(survivors, old_data, old_model)
    assert plan.chips <= survivors                 # never oversubscribe
    assert old_model % plan.model == 0             # weight divisibility
    assert plan.data * plan.model == plan.chips
    assert plan.microbatch_multiplier >= 1
    assert plan.data * plan.microbatch_multiplier >= old_data


@pytest.mark.parametrize("plan,shape", [
    (elastic.MeshPlan(2, 1, 2), {"data": 2, "model": 1}),
    (elastic.MeshPlan(2, 2, 1), {"data": 2, "model": 2}),
    (elastic.MeshPlan(1, 4, 1), {"data": 1, "model": 4})])
def test_build_mesh_shapes(plan, shape):
    devices = [torch.device("cpu")] * 6
    mesh = elastic.build_mesh(plan, devices)
    assert mesh.shape == shape and mesh.devices == devices[:plan.chips]
    with pytest.raises(ValueError, match="needs"):
        elastic.build_mesh(plan, devices[:plan.chips - 1])


class _HostLost(Exception):
    pass


def test_recover_onto_fewer_shards_resumes(tmp_path):
    """gia, 64 points a step on a 4-shard mesh, saving every 4 steps;
    host1 (shards 2 and 3) stops beating after step 3, the policy's
    FailureEvent at the step-7 chunk end stops the run; recover onto the
    2-shard plan, state equal to the step-7 save bit for bit, then 2
    micro-batches a step to step 16: each loss within 1e-6 of an
    uninterrupted 4-shard run's."""
    _, ct, p0, batch = jax_start("gia", 64)

    def loss_fn(p, b):
        return ttrain.field_loss(p, ct, b)

    def batch_fn(i):
        return _t_batch(batch(i))
    mesh4 = Mesh([CPU] * 4, ("data",))
    opt = toptim.AdamConfig(lr=1e-2)

    def start():
        return tloop.init_train_state(tfields.from_jax_params(p0, ct, "cpu"))

    whole = []
    tloop.TrainEngine(tloop.EngineConfig(steps=16, chunk_steps=4),
                      tloop.make_scanned_step(loss_fn, opt, mesh=mesh4),
                      batch_fn=batch_fn).run(
        start(), on_metrics=lambda i, r, s: whole.append(r["loss"]))

    clock = [0.0]
    mon = HeartbeatMonitor(timeout_s=5.0, clock=lambda: clock[0])

    def beat(end, state):            # host0 runs the engine; host1 stops
        clock[0] += 10.0
        mon.beat("host0")
        if end < 7:
            mon.beat("host1")
    events, saved = [], {}

    def lost(ev):
        events.append(ev)
        raise _HostLost

    def grab(i, row, state):
        if i == 7:
            saved.update({k: v.clone() if torch.is_tensor(v) else v
                          for k, v in store._flatten(state)})
    ckpt = str(tmp_path / "ckpt")
    engine = tloop.TrainEngine(
        tloop.EngineConfig(steps=16, chunk_steps=4, ckpt_dir=ckpt,
                           ckpt_every=4, host="host0"),
        tloop.make_scanned_step(loss_fn, opt, mesh=mesh4),
        batch_fn=batch_fn, monitor=mon, on_chunk_end=beat, on_event=lost)
    with pytest.raises(_HostLost):
        engine.run(start(), on_metrics=grab)
    assert events == [FailureEvent("dead", ("host1",), 7)]
    assert store.latest_step(ckpt) == 7

    plan = elastic.remesh_plan(2, 4, 1)
    mesh2, step_fn, state, step = elastic.recover(
        ckpt, start(), plan, devices=[CPU] * 4,
        make_step=lambda mesh, rules: tloop.make_scanned_step(
            loss_fn, opt, grad_accum=plan.microbatch_multiplier, mesh=mesh,
            rules=rules))
    assert step == 7 and mesh2.shape == {"data": 2, "model": 1}
    restored = dict(store._flatten(state))
    assert restored.keys() == saved.keys()
    for k, v in saved.items():
        assert (torch.equal(restored[k], v) if torch.is_tensor(v)
                else restored[k] == v), k

    resumed = []
    tloop.TrainEngine(tloop.EngineConfig(steps=16, chunk_steps=4,
                                         ckpt_dir=ckpt, ckpt_every=4),
                      step_fn, batch_fn=batch_fn).run(
        state, on_metrics=lambda i, r, s: resumed.append((i, r["loss"])))
    assert [i for i, _ in resumed] == list(range(8, 16))
    for i, loss in resumed:
        assert abs(loss - whole[i]) <= RESUME_TOL * abs(whole[i]), (
            i, loss, whole[i])


def test_recover_without_a_checkpoint_raises(tmp_path):
    _, ct, p0, _ = jax_start("gia", 8)
    state = tloop.init_train_state(tfields.from_jax_params(p0, ct, "cpu"))
    with pytest.raises(FileNotFoundError):
        elastic.recover(str(tmp_path), state, elastic.MeshPlan(1, 1, 1),
                        devices=[CPU])


def test_recover_builds_no_step_without_make_step(tmp_path):
    """The restore lands on the mesh's first device in the template's
    dtypes, whatever device the template lies on."""
    _, ct, p0, _ = jax_start("gia", 8)
    state = tloop.init_train_state(tfields.from_jax_params(p0, ct, "cpu"))
    store.save(state, 3, str(tmp_path))
    template = tloop.init_train_state(tfields.from_jax_params(p0, ct, "cpu"))
    mesh, step_fn, got, step = elastic.recover(
        str(tmp_path), template, elastic.MeshPlan(2, 2, 1),
        devices=[CPU] * 4)
    assert step_fn is None and step == 3 and mesh.shape == {"data": 2,
                                                            "model": 2}
    for (_, a), (_, b) in zip(store._flatten(got), store._flatten(state)):
        assert (torch.equal(a, b) and a.device == CPU) if torch.is_tensor(
            a) else a == b
