"""The LM port's configs against the JAX package's: the ten archs and
their ``reduced_config``s field by field, the derived counts and periods,
the shape cells, the field-app registry entries, and the parameter trees'
shapes and logical axes (the LM sharding reads them)."""
import dataclasses

import jax
import pytest
import torch

from repro.common.param import count_params as jcount, unbox as junbox
from repro.configs import registry as jregistry, shapes as jshapes
from repro.models import blocks as jblocks, encdec as jencdec, lm as jlm
from repro_torch.common.param import KeyGen, count_params, tree_bytes, \
    unbox
from repro_torch.configs import registry as tregistry, shapes as tshapes
from repro_torch.models import blocks as tblocks, encdec as tencdec, \
    lm as tlm

ARCHS = jregistry.list_archs()


def test_the_same_ten_archs():
    assert tregistry.list_archs() == ARCHS and len(ARCHS) == 10
    assert tregistry.FIELD_APPS == jregistry.FIELD_APPS
    assert tregistry.FIELD_ENCODINGS == jregistry.FIELD_ENCODINGS


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_by_field(arch):
    for get in ("get_config", "reduced_config"):
        cj = getattr(jregistry, get)(arch)
        ct = getattr(tregistry, get)(arch)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj), get
        assert type(ct).__module__ == "repro_torch.models.config"
        assert ct.adtype == getattr(torch, cj.act_dtype)
        assert ct.pdtype == torch.float32 and ct.head_dim_ == cj.head_dim_


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_periods_and_kinds_match(arch):
    for get in ("get_config", "reduced_config"):
        cj = getattr(jregistry, get)(arch)
        ct = getattr(tregistry, get)(arch)
        assert ct.param_count() == cj.param_count()
        assert ct.active_param_count() == cj.active_param_count()
        assert tblocks.block_period(ct) == jblocks.block_period(cj)
        assert [ct.layer_kind(i) for i in range(ct.n_layers)] == \
            [cj.layer_kind(i) for i in range(cj.n_layers)]
        assert [ct.ffn_kind(i) for i in range(ct.n_layers)] == \
            [cj.ffn_kind(i) for i in range(cj.n_layers)]
    assert tregistry.get_config("jamba-v0.1-52b") and \
        tblocks.block_period(tregistry.get_config("jamba-v0.1-52b")) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_cells_and_applicability_match(arch):
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for shape in jshapes.SHAPES:
        assert tshapes.shape_applicable(tregistry.get_config(arch), shape) \
            == jshapes.shape_applicable(jregistry.get_config(arch), shape)


@pytest.mark.parametrize("app", jregistry.FIELD_APPS)
def test_field_config_is_the_ports(app):
    for enc in jregistry.FIELD_ENCODINGS:
        ct = tregistry.field_config(app, enc)
        assert type(ct).__module__.startswith("repro_torch.")
        assert dataclasses.asdict(ct) == dataclasses.asdict(
            jregistry.field_config(app, enc))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_param_tree_shapes_and_axes_match(arch, size):
    """The port's init on the meta device (nothing allocated) against
    ``jax.eval_shape`` of the JAX init: the same keys, stacked shapes,
    dtypes and logical axes, so the same count and bytes."""
    get = "reduced_config" if size == "reduced" else "get_config"
    cj = getattr(jregistry, get)(arch)
    ct = getattr(tregistry, get)(arch)
    if cj.is_encdec:
        jtree = jax.eval_shape(lambda k: jencdec.init_encdec(k, cj),
                               jax.random.PRNGKey(0))
        ttree = tencdec.init_encdec(KeyGen(0, "meta"), ct)
    else:
        jtree = jax.eval_shape(lambda k: jlm.init_lm(k, cj),
                               jax.random.PRNGKey(0))
        ttree = tlm.init_lm(KeyGen(0, "meta"), ct)
    jp, jaxes = junbox(jtree)
    tp, taxes = unbox(ttree)
    assert taxes == jaxes
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace(
            "torch.", "")), tp)
    assert count_params(tp) == jcount(jp)
    assert tree_bytes(tp) == 4 * count_params(tp)
    assert all(a.device.type == "meta" for a in jax.tree.leaves(tp))
