"""repro_torch's checkpoint store against the JAX package's, on the CPU:
mirrors of every test in ``tests/test_checkpoint.py``, checkpoints that
cross between the packages both ways (a train state with f32 params, a
bf16 table, and int8 and fp8 ``quantize_field`` trees), byte-identical
files, the asynchronous snapshot, and the engine's kill and resume, which
is bitwise on the CPU.

Every comparison here is exact: a checkpoint carries bytes.
"""
import json
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core import fields as jfields
from repro.quant import QuantSpec as JQuantSpec
from repro.quant import quantize_field as jquantize_field
from repro.train import loop as jloop
from repro_torch.checkpoint import store
from repro_torch.core import fields as tfields
from repro_torch.core import train as ttrain
from repro_torch.quant import QuantSpec
from repro_torch.train import loop as tloop
from repro_torch.train import optim as toptim
from tests.test_torch_grad import _t_batch, jax_start


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(8, 16)).astype(
        np.float32)),
        "nested": {"b": torch.arange(12, dtype=torch.int32),
                   "c": torch.tensor(3.5)}}


def _leaves(tree):
    return [leaf for _, leaf in store._flatten(tree)]


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            x = x.view(torch.int16 if x.dtype == torch.bfloat16
                       else torch.uint8)
        return x.contiguous().numpy().tobytes()
    if isinstance(x, int):
        return np.asarray(x, np.int32).tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_same_bytes(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bytes(x) == _bytes(y)


def _steps(path):
    return sorted(int(p.name.split("_")[1])
                  for p in Path(path).glob("step_*"))


# ------------------------------------------- mirrors of test_checkpoint.py
def test_roundtrip(tmp_path):
    t = _tree()
    store.save(t, 7, tmp_path)
    got = store.restore(tmp_path, t)
    for a, b in zip(_leaves(t), _leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_step_and_gc(tmp_path):
    t = _tree()
    for s in (1, 5, 12, 20):
        store.save(t, s, tmp_path)
    assert store.latest_step(tmp_path) == 20
    store.gc_old(tmp_path, keep=2)
    assert _steps(tmp_path) == [12, 20]


def test_crc_detects_corruption(tmp_path):
    t = _tree()
    d = store.save(t, 3, tmp_path)
    f = next(d.glob("leaf_*.npy"))
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        store.restore(tmp_path, t, verify=True)


def test_structure_mismatch_rejected(tmp_path):
    store.save(_tree(), 1, tmp_path)
    with pytest.raises(ValueError):
        store.restore(tmp_path, {"a": torch.zeros((8, 16))})


def test_async_checkpointer(tmp_path):
    ck = store.AsyncCheckpointer(tmp_path, keep=2)
    t = _tree()
    for s in (0, 10, 20):
        ck.save(t, s)
    ck.wait()
    assert store.latest_step(tmp_path) == 20
    assert len(_steps(tmp_path)) == 2
    assert len(ck.blocked_s) == 3


def test_atomic_no_partial_dirs(tmp_path):
    """Temporary directories never count as checkpoints."""
    store.save(_tree(), 2, tmp_path)
    (Path(tmp_path) / ".tmp_step_9_x").mkdir()
    assert store.latest_step(tmp_path) == 2


def test_restore_dtype_cast(tmp_path):
    store.save({"w": torch.ones((4, 4))}, 0, tmp_path)
    got = store.restore(tmp_path, {"w": torch.empty((4, 4),
                                                    dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.ones((4, 4)))


def _quantized_tree():
    """Int8 codes with f32 scale siblings, and bf16 and fp8 leaves."""
    rng = np.random.default_rng(3)
    return {
        "grid": torch.from_numpy(rng.integers(-127, 128, (4, 16, 2),
                                              dtype=np.int8)),
        "grid_scale": torch.from_numpy(rng.random((4, 1, 1),
                                                  dtype=np.float32)),
        "mlp": {"w_in": torch.from_numpy(rng.normal(size=(8, 16)).astype(
            np.float32)).to(torch.bfloat16),
            "w8": (torch.from_numpy(rng.normal(size=(4, 4)).astype(
                np.float32)) * 0.1).to(torch.float8_e4m3fn)}}


def test_mixed_dtype_roundtrip(tmp_path):
    t = _quantized_tree()
    store.save(t, 1, tmp_path)
    man = json.loads((Path(tmp_path) / "step_00000001"
                      / store.MANIFEST).read_text())
    dts = {l["path"]: l["dtype"] for l in man["leaves"]}
    assert dts["['grid']"] == "int8"
    assert dts["['mlp']['w_in']"] == "bfloat16"
    assert dts["['mlp']['w8']"] == "float8_e4m3fn"
    got = store.restore(tmp_path, t)
    for a, b in zip(_leaves(t), _leaves(got)):
        assert a.dtype == b.dtype
    _assert_same_bytes(t, got)


def test_mixed_dtype_roundtrip_async(tmp_path):
    ck = store.AsyncCheckpointer(tmp_path)
    t = _quantized_tree()
    ck.save(t, 5)
    ck.wait()
    got = store.restore(tmp_path, t)
    assert got["grid"].dtype == torch.int8
    assert got["mlp"]["w8"].dtype == torch.float8_e4m3fn
    assert torch.equal(t["grid"], got["grid"])


# ------------------------------------------------------- the two packages
def _jax_states():
    """name -> (JAX tree, port tree of the same bytes): a train state
    (params, Adam's moments and step), a bf16 table, and the int8 and fp8
    ``quantize_field`` trees."""
    cj, ct, p0, _ = jax_start("nerf", 4)
    rng = np.random.default_rng(0)
    p0 = {**p0, "grid": rng.uniform(-1, 1, p0["grid"].shape).astype(
        np.float32)}
    jopt = jloop.optim.adam_init(p0)
    mu = jax.tree.map(lambda x: np.asarray(x) + 0.25, jopt.mu)
    jopt = jopt._replace(step=jnp.int32(9), mu=mu)
    jstate = {"params": p0, "opt": jopt}
    tp = tfields.from_jax_params(p0, ct, "cpu")
    tstate = {"params": tp, "opt": toptim.AdamState(
        step=9, mu=tfields.from_jax_params(mu, ct, "cpu"),
        nu=tfields.from_jax_params(jax.tree.map(np.asarray, jopt.nu), ct,
                                   "cpu"))}
    out = {"train_state": (jstate, tstate)}
    bf = np.asarray(jnp.asarray(p0["grid"]).astype(jnp.bfloat16))
    out["bf16_table"] = ({**p0, "grid": bf},
                         {**tp, "grid": tp["grid"].to(torch.bfloat16)})
    for name, spec in (("int8", JQuantSpec("int8")),
                       ("fp8", JQuantSpec("fp8_e4m3", mlp_qtype="int8"))):
        jq = jax.tree.map(np.asarray, jquantize_field(p0, spec))
        tcfg = ct.with_quant(QuantSpec(spec.table_qtype,
                                       mlp_qtype=spec.mlp_qtype))
        out[name] = (jq, tfields.from_jax_params(jq, tcfg, "cpu"))
    return out


@pytest.mark.parametrize("name", ["train_state", "bf16_table", "int8", "fp8"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, name):
    jtree, ttree = _jax_states()[name]
    jstore.save(jtree, 4, tmp_path)
    got = store.restore(tmp_path, ttree)
    if name == "train_state":
        assert got["opt"].step == 9 and isinstance(got["opt"].step, int)
    for a, b in zip(_leaves(ttree), _leaves(got)):
        assert type(a) is type(b)
        assert not isinstance(a, torch.Tensor) or a.dtype == b.dtype
    _assert_same_bytes(ttree, got)


@pytest.mark.parametrize("name", ["train_state", "bf16_table", "int8", "fp8"])
def test_port_checkpoint_restores_in_jax(tmp_path, name):
    jtree, ttree = _jax_states()[name]
    store.save(ttree, 4, tmp_path)
    got = jstore.restore(tmp_path, jax.eval_shape(lambda x: x, jtree))
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(got)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["train_state", "bf16_table", "int8", "fp8"])
def test_checkpoint_files_are_byte_identical(tmp_path, name):
    """The same tree saved by each package: every file alike, manifest
    (paths, dtypes, CRCs) included."""
    jtree, ttree = _jax_states()[name]
    dj = jstore.save(jtree, 4, tmp_path / "jax")
    dt = store.save(ttree, 4, tmp_path / "port")
    names = sorted(p.name for p in dj.iterdir())
    assert names == sorted(p.name for p in dt.iterdir())
    for n in names:
        assert (dj / n).read_bytes() == (dt / n).read_bytes(), n


def test_leaf_paths_are_jax_keystr():
    _, ttree = _jax_states()["train_state"]
    jtree, _ = _jax_states()["train_state"]
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert [p for p, _ in store._flatten(ttree)] == jpaths
    assert "['opt'].step" in jpaths and "['params']['grid']" in jpaths


def test_crc_is_over_the_raw_bytes(tmp_path):
    t = _quantized_tree()
    d = store.save(t, 0, tmp_path)
    man = json.loads((d / store.MANIFEST).read_text())
    for rec, leaf in zip(man["leaves"], _leaves(t)):
        assert rec["crc32"] == zlib.crc32(_bytes(leaf)) & 0xFFFFFFFF


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    """The caller updates the state in place right after ``save``: the
    checkpoint holds the values at the call."""
    t = _tree()
    before = t["a"].clone()
    ck = store.AsyncCheckpointer(tmp_path)
    ck.save(t, 1)
    t["a"].add_(1.0)
    ck.wait()
    got = store.restore(tmp_path, t)
    assert torch.equal(got["a"], before)


# --------------------------------------------------- engine kill & resume
def test_kill_and_resume_bitwise(tmp_path):
    """Stopped at step 8, then resumed to 16: the stitched losses and the
    params equal an uninterrupted run's bit for bit on the CPU, and the
    resumed run continues at step 8 with the restored Adam step."""
    _, ct, _, _ = jax_start("gia", 8)
    kw = dict(steps=16, batch_size=128, seed=0, chunk_steps=4,
              ckpt_every=8, device="cpu")
    full = []
    p_full, _ = ttrain.train_field(
        ct, on_metrics=lambda i, row, st: full.append((i, row["loss"])),
        **kw)
    ckpt = str(tmp_path / "ckpt")
    part = []
    ttrain.train_field(ct, **{**kw, "steps": 8}, ckpt_dir=ckpt,
                       on_metrics=lambda i, row, st: part.append(
                           (i, row["loss"])))
    assert store.latest_step(ckpt) == 7
    steps_seen = []
    p_res, _ = ttrain.train_field(
        ct, **kw, ckpt_dir=ckpt,
        on_metrics=lambda i, row, st: (part.append((i, row["loss"])),
                                       steps_seen.append(st["opt"].step)))
    assert [i for i, _ in part] == list(range(16))
    assert part == full                    # float equality: bitwise
    assert steps_seen[-1] == 16
    for a, b in zip(_leaves(p_full), _leaves(p_res)):
        assert torch.equal(a, b)
    assert store.latest_step(ckpt) == 15
    assert not list(Path(ckpt).glob(".tmp_step_*"))


def test_engine_saves_on_the_chunk_grid(tmp_path):
    """Saves at chunk ends once ckpt_every steps have passed, and at the
    last step; keeps ckpt_keep; a complete run resumes to nothing."""
    _, ct, p0, batch = jax_start("gia", 16)
    step_fn = tloop.make_scanned_step(
        lambda p, b: ttrain.field_loss(p, ct, b), toptim.AdamConfig())
    cfg = tloop.EngineConfig(steps=11, chunk_steps=3, ckpt_dir=str(
        tmp_path), ckpt_every=4, ckpt_keep=10)
    eng = tloop.TrainEngine(cfg, step_fn,
                            batch_fn=lambda i: _t_batch(batch(i)))
    state = tloop.init_train_state(tfields.from_jax_params(p0, ct, "cpu"))
    state, hist = eng.run(state)
    assert len(hist) == 11
    assert _steps(tmp_path) == [5, 10]      # ends 2, 5, 8, 10
    assert len(eng.checkpointer.blocked_s) == 2
    state2, hist2 = eng.run(tloop.init_train_state(
        tfields.from_jax_params(p0, ct, "cpu")))
    assert hist2 == [] and state2["opt"].step == 11
    _assert_same_bytes(state, state2)
