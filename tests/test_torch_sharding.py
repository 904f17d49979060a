"""The port's sharding rules against the reference's, element by element,
on the reference's duck-typed production meshes (no process group):
``FakeMesh(data=16, model=16)`` and ``FakeMesh(pod=2, data=16,
model=16)``, as ``tests/test_launch.py`` builds them.

The port's param and state shapes come from its ``meta`` init, the
reference's from ``jax.eval_shape``; the two trees have the same paths,
so each leaf's spec is compared as a tuple. Also held here: the KV
expansion, the batch split, the microbatch rule, the input shapes and
the parameter counts, and the port's own use of a spec (local shapes
and slices, ``DTensor`` placements).
"""

import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import shapes_for as jshapes_for
from repro.launch import sharding as jsh
from repro.launch import steps as jsteps
from repro.launch.steps import default_microbatches as jmicrobatches
from repro.models import get_model as jget_model
from repro.models.layers import serve_kv_expand as jserve_kv_expand
from repro.planner import plan_residency as jplan_residency
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.steps import abstract_cell, default_microbatches
from repro_torch.models import get_model
from repro_torch.models.layers import serve_kv_expand


class FakeMesh:
    """Duck-typed mesh: only .shape and .axis_names are consulted."""
    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESHES = {"pod": FakeMesh(data=16, model=16),
          "multi": FakeMesh(pod=2, data=16, model=16)}


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))


def _jflat(tree) -> dict:
    """{path: tuple(spec)} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {tuple(_key(k) for k in path): tuple(s) for path, s in flat}


def _flat(tree) -> dict:
    return {path: tuple(s) for path, s in sh.flatten(tree)}


@functools.cache
def _params(arch):
    """(port meta params, reference abstract params) at full width."""
    cfg, jcfg = get_config(arch), jget(arch)
    return (get_model(cfg).init_params(cfg, device="meta"),
            jax.eval_shape(lambda: jget_model(jcfg).init_params(
                jcfg, jax.random.PRNGKey(0))))


def test_arch_ids_shapes_and_param_counts_equal_the_reference():
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_config_rules_equal_the_reference(arch):
    """shapes_for, param_count (full and reduced), serve_kv_expand at tp
    1-16 and default_microbatches for every shape on both meshes."""
    cfg, jcfg = get_config(arch), jget(arch)
    assert shapes_for(arch) == jshapes_for(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.reduced().param_count() == jcfg.reduced().param_count()
    for tp in (1, 2, 4, 8, 16):
        assert serve_kv_expand(cfg, tp) == jserve_kv_expand(jcfg, tp), tp
    for mesh in MESHES.values():
        for name in shapes_for(arch):
            assert default_microbatches(cfg, SHAPES[name], mesh) == \
                jmicrobatches(jcfg, JSHAPES[name], mesh), name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", ["plain", "planned", "all_groups",
                                  "wide_tp", "train_cell"])
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_param_pspecs_equal_the_reference(arch, mode, mesh):
    """Plain; with the streamed groups of the reference's own training
    plan (``plan_residency(train=True)`` at 16 x 16: embed and ffn for
    command-r-plus-104b, none for the others); with every residency
    group streamed (each FSDP pattern exercised); wide TP; and the
    train_4k cell's (``abstract_cell``: the params' specs with the
    planner's streamed groups, AdamW's and the batch's)."""
    mesh = MESHES[mesh]
    params, jparams = _params(arch)
    if mode == "train_cell":
        got = abstract_cell(get_config(arch), "train_4k", mesh).in_pspecs
        want = jsteps.abstract_cell(jget(arch), "train_4k", mesh).in_pspecs
        assert _flat(got[0]) == _jflat(want[0])
        assert tuple(got[1].step) == tuple(want[1].step) == ()
        assert _flat(got[1].m) == _flat(got[1].v) == _jflat(want[1].m) \
            == _jflat(want[1].v)
        assert _flat(got[2]) == _jflat(want[2])
        return
    kw = {}
    if mode == "planned":
        kw["streamed_groups"] = jplan_residency(
            jget(arch), tp=16, dp=16, train=True).streamed
    if mode == "all_groups":
        kw["streamed_groups"] = frozenset(jsh._GROUP_PATTERNS)
    if mode == "wide_tp":
        kw["wide_tp"] = True
    got = _flat(sh.param_pspecs(params, mesh, **kw))
    want = _jflat(jsh.param_pspecs(jparams, mesh, **kw))
    assert got == want


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_opt_pspecs_equal_the_reference(arch):
    """AdamW's state: the step replicated, both moments as their params,
    on both meshes."""
    params, jparams = _params(arch)
    for mesh in MESHES.values():
        got = sh.opt_pspecs(sh.param_pspecs(params, mesh), mesh)
        want = jsh.opt_pspecs(jsh.param_pspecs(jparams, mesh), mesh)
        assert tuple(got.step) == tuple(want.step) == ()
        assert _flat(got.m) == _flat(got.v) == _jflat(want.m) \
            == _jflat(want.v)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_state_pspecs_equal_the_reference(arch, mesh):
    """The decode state of the decode_32k cell (B 128, T 32768) with the
    serving KV expansion at 16-way TP."""
    mesh = MESHES[mesh]
    cfg, jcfg = get_config(arch), jget(arch)
    e = serve_kv_expand(cfg, 16)
    state = get_model(cfg).init_decode_state(cfg, 128, 32768, kv_expand=e,
                                             device="meta")
    jstate = jax.eval_shape(lambda: jget_model(jcfg).init_decode_state(
        jcfg, 128, 32768, kv_expand=e))
    got = _flat(sh.state_pspecs(state, mesh))
    want = _jflat(jsh.state_pspecs(jstate, mesh))
    assert got == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("size", [1, 16, 128, 256])
def test_batch_dim_spec_equals_the_reference(size, mesh):
    mesh = MESHES[mesh]
    assert sh.batch_dim_spec(size, mesh) == jsh.batch_dim_spec(size, mesh)
    batch = {"tokens": torch.empty((size, 7), device="meta")}
    assert tuple(sh.batch_pspecs(batch, mesh)["tokens"]) == tuple(
        jsh.batch_pspecs({"tokens": jax.ShapeDtypeStruct((size, 7),
                                                          "int32")},
                         mesh)["tokens"])


def test_local_slices_follow_the_spec_order():
    """A dim split over several axes takes the first as the major one,
    as the reference's PartitionSpec does; ``local_shape`` and
    ``local_slice`` agree; ``to_shardings`` names DTensor placements in
    mesh order and refuses an axis order against the mesh's."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 4), ("data", "model"))
    t = torch.arange(64).view(8, 8)
    spec = sh.P(("model", "data"), None)
    seen = []
    for d in range(2):
        for m in range(4):
            mesh.coords = {"data": d, "model": m}
            part = sh.local_slice(t, spec, mesh)
            assert tuple(part.shape) == sh.local_shape(t.shape, spec, mesh)
            seen.append(int(part[0, 0]) // 8)
            assert seen[-1] == m * 2 + d
    assert sorted(seen) == list(range(8))
    assert sh.to_shardings(sh.P(None, "model"), mesh) == \
        (Replicate(), Shard(1))
    assert sh.to_shardings(sh.P(("data", "model")), mesh) == \
        (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="order"):
        sh.to_shardings(spec, mesh)
