"""The LM sharding's placement (``repro_torch.common.partitioning``,
``parallel/api``'s spec functions) against the JAX package's, computed
in-process on stand-in meshes (``SimpleNamespace(shape=...)``: the spec
functions read only ``mesh.shape``), and the memory plan of full-width
configs against JAX's ``NamedSharding.shard_shape`` on an
``AbstractMesh``.

For every reduced arch, on the (2, 2), (2, 4), (4, 2) and (1, 4) meshes
under the presets baseline, nosp, noz, ep2d and tinydp: ``param_specs``,
``train_state_specs`` (with and without compression), ``batch_specs`` and
``cache_specs`` as tuples, and the fallbacks each records, equal entry for
entry (and in order)."""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding

from repro.common import partitioning as jpart
from repro.configs import registry as jregistry
from repro.parallel import api as japi
from repro_torch.common import partitioning as tpart
from repro_torch.configs import registry as tregistry
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import api as tapi

MESHES = ((2, 2), (2, 4), (4, 2), (1, 4))
PRESETS = ("baseline", "nosp", "noz", "ep2d", "tinydp")
BATCH, SEQ, CAPACITY, ENC = 6, 32, 32, 16
FULL = ("olmoe-1b-7b", "jamba-v0.1-52b", "qwen2-vl-72b")
CPU = torch.device("cpu")


_jax_abstract = functools.lru_cache(maxsize=None)(japi.abstract_params)


@pytest.fixture(autouse=True)
def cached_jax_abstract_params(monkeypatch):
    """JAX's ``param_specs`` traces the init each call: once per config
    here (the result is a pure function of it)."""
    monkeypatch.setattr(japi, "abstract_params", _jax_abstract)


def stand_in(shape):
    return SimpleNamespace(shape=dict(zip(("data", "model"), shape)))


def as_tuples(tree):
    """A spec tree (dicts, AdamStates; JAX or port specs) as nested plain
    data: dicts, lists for NamedTuples, tuples for specs."""
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [as_tuples(getattr(tree, f)) for f in tree._fields]
    return tuple(tree)


def batch_shapes(cfg):
    """(JAX ShapeDtypeStructs, numpy arrays) of a train batch of ``cfg``."""
    if cfg.frontend == "vision":
        shapes = {"embeddings": (BATCH, SEQ, cfg.d_model),
                  "positions": (3, BATCH, SEQ), "labels": (BATCH, SEQ)}
    elif cfg.is_encdec:
        shapes = {"tokens": (BATCH, SEQ),
                  "enc_embeddings": (BATCH, ENC, cfg.d_model)}
    else:
        shapes = {"tokens": (BATCH, SEQ)}
    return ({k: jax.ShapeDtypeStruct(s, np.float32)
             for k, s in shapes.items()},
            {k: np.zeros(s, np.float32) for k, s in shapes.items()})


def specs_of_both(arch, shape, preset, jcfg, tcfg):
    """The four spec functions and the fallbacks, from each package."""
    mesh = stand_in(shape)
    out = []
    jb, tb = batch_shapes(jcfg)
    enc = ENC if jcfg.is_encdec else 0
    for mod, cfg, part, batch in ((japi, jcfg, jpart, jb),
                                  (tapi, tcfg, tpart, tb)):
        rules = part.rule_preset(preset)
        _, pspecs = mod.param_specs(cfg, mesh, rules)
        got = {"params": as_tuples(pspecs),
               "state": as_tuples(mod.train_state_specs(pspecs)),
               "state_efb": as_tuples(mod.train_state_specs(
                   pspecs, compression=True)),
               "batch": as_tuples(mod.batch_specs(cfg, batch, mesh, rules)),
               "cache": as_tuples(mod.cache_specs(
                   cfg, mesh, rules, BATCH, CAPACITY, enc)[1]),
               "fallbacks": list(rules.fallbacks)}
        out.append(got)
    return out


@pytest.mark.parametrize("arch", tregistry.list_archs())
def test_specs_and_fallbacks_equal_jax(arch):
    jcfg, tcfg = jregistry.reduced_config(arch), tregistry.reduced_config(arch)
    n_fallbacks = 0
    for shape in MESHES:
        for preset in PRESETS:
            want, got = specs_of_both(arch, shape, preset, jcfg, tcfg)
            for key in want:
                assert got[key] == want[key], (arch, shape, preset, key)
            n_fallbacks += len(want["fallbacks"])
    assert n_fallbacks > 0          # the fallback path is exercised


@pytest.mark.parametrize("arch", FULL)
def test_full_configs_specs_and_shard_bytes(arch):
    """Full width: the specs and fallbacks as above on (2, 2) and (4, 1),
    and each position's bytes against the sum of JAX's shard shapes."""
    jcfg, tcfg = jregistry.get_config(arch), tregistry.get_config(arch)
    for shape in ((2, 2), (4, 1)):
        for preset in ("baseline", "tinydp"):
            want, got = specs_of_both(arch, shape, preset, jcfg, tcfg)
            for key in want:
                assert got[key] == want[key], (arch, shape, preset, key)
        amesh = AbstractMesh(shape, ("data", "model"))
        shapes, specs = japi.param_specs(jcfg, amesh, jpart.rule_preset(
            "baseline"))
        want = sum(int(np.prod(JNamedSharding(amesh, s).shard_shape(
            l.shape))) * l.dtype.itemsize for l, s in zip(
            jax.tree.leaves(shapes), jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                    PartitionSpec))))
        got = tapi.shard_param_bytes(tcfg, stand_in(shape),
                                     tpart.rule_preset("baseline"))
        assert got == [want] * (shape[0] * shape[1])


def test_olmoe_train_state_fits_on_four_devices():
    """olmoe-1b-7b's f32 params are 6.92 GB a device on (2, 2) and on
    (4, 1), and its whole train
    state (16 bytes a parameter, 110.7 GB) fits no 80 GB device alone;
    sharded, each position's state and gathered bf16 copy fit."""
    cfg = tregistry.get_config("olmoe-1b-7b")
    for shape in ((2, 2), (4, 1)):
        per = tapi.shard_param_bytes(cfg, stand_in(shape))
        assert len(set(per)) == 1 and round(per[0] / 1e9, 2) == 6.92
    mesh = Mesh(np.array([CPU] * 4, dtype=object).reshape(4, 1),
                ("data", "model"))
    tc = tapi.TrainConfig()
    with pytest.raises(MemoryError, match="on cpu"):
        tapi.check_fits(cfg, train_cfg=tc, mesh=mesh, device_bytes=80e9)
    need = tapi.train_state_bytes(cfg, tc, mesh=mesh)
    assert max(need) < 80e9 < sum(need)
    assert tapi.train_state_bytes(cfg, tc) > 80e9


def test_partition_spec_and_named_sharding():
    """The port's spec type is JAX's tuple, and its NamedSharding gives
    JAX's shard shapes and slices (JAX's slices from an AbstractMesh's
    shard shape and the row-major mesh coordinates)."""
    assert tuple(tpart.P("data", ("pod", "model"), None)) == tuple(
        jax.sharding.PartitionSpec("data", ("pod", "model"), None))
    mesh = Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 4),
                ("data", "model"))
    s = tpart.NamedSharding(mesh, tpart.P(("model", "data"), None))
    assert s.shard_shape((16, 3)) == JNamedSharding(
        AbstractMesh((2, 4), ("data", "model")),
        jax.sharding.PartitionSpec(("model", "data"), None)
    ).shard_shape((16, 3)) == (2, 3)
    # position (d, m) holds block m * 2 + d: 'model' is the major axis
    starts = [idx[0].start for idx in s.indices((16, 3))]
    assert starts == [0, 4, 8, 12, 2, 6, 10, 14]
    rep = tpart.NamedSharding(mesh, tpart.P(None, "model"))
    assert rep.owners((4, 8)) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="does not split"):
        s.shard_shape((6, 3))


def test_activation_hints_keep_values_and_record_once():
    rules = tpart.rule_preset("baseline")
    sharder = tpart.ActivationSharder(stand_in((2, 4)), rules)
    x = torch.ones((3, 8, 6))
    for _ in range(3):
        assert sharder(x, "batch", "act_seq", "act_mlp") is x
    assert rules.fallbacks == [("act", 0, "batch", "data", 3),
                               ("act", 2, "act_mlp", "model", 6)]
    jrules = jpart.rule_preset("baseline")
    jpart.divisible_fallback(stand_in((2, 4)), (3, 8, 6),
                             ("batch", "act_seq", "act_mlp"), jrules, "act")
    assert rules.fallbacks == jrules.fallbacks
    assert tpart.NULL_SHARDER(x, "batch") is x
    sp = tpart.sequence_parallel_rules(tpart.rule_preset("nosp"))
    assert sp.rules == jpart.sequence_parallel_rules(
        jpart.rule_preset("nosp")).rules
