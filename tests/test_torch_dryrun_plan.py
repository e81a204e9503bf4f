"""The port's dry-run plans against the reference's, for every arch at its
full config on both production meshes.

The reference side runs ``repro.launch.dryrun.lower_cell`` itself with
``jax.jit`` replaced by a stub whose ``lower`` returns its arguments, so its
``ShapeDtypeStruct`` arguments (with their ``NamedSharding``s on an
``AbstractMesh``) and the model it built (block_q, the residual, expert and
context shardings) come out without lowering.  Every comparison is exact:
shapes, dtypes, logical axes, partition specs, byte counts.
"""

import dataclasses
import functools
import math
import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

# The reference's dry-run module sets XLA_FLAGS to 512 host devices when
# imported; the backend is up before it, and the flag is put back after.
jax.devices()
_saved = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as rdr  # noqa: E402

if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

import repro.training as rtr  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import input_specs as jinput_specs  # noqa: E402
from repro.configs import shape_applicable as jshape_applicable  # noqa: E402
from repro.configs.shapes import cache_specs as jcache_specs  # noqa: E402
from repro.models.model import build_model as jbuild_model  # noqa: E402

import torch_parity  # noqa: E402,F401  (one intra-op thread)
from repro_torch import sharding as sh  # noqa: E402
from repro_torch import training  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, cache_specs, get_config,  # noqa: E402
                                 input_specs, shape_applicable)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCH_NAMES = sorted(ARCHS)
MESHES = {
    "single": (AbstractMesh((16, 16), ("data", "model")), make_production_mesh()),
    "multi": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
              make_production_mesh(multi_pod=True)),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32,
          "uint32": torch.uint32, "bool": torch.bool}


def jax_flat(tree):
    """{keystr path: leaf} of a JAX tree."""
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_flat(tree, prefix=""):
    """{path: leaf} of a port tree, with ``jax.tree_util.keystr``'s path
    syntax: ``['key']`` for a dict, ``.name`` for a named tuple's field or a
    dataclass's, ``[i]`` for a tuple's index; a ``TensorSpec`` or a
    ``NamedSharding`` is a leaf."""
    if isinstance(tree, (sh.TensorSpec, sh.NamedSharding)):
        return {prefix: tree}
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in port_flat(tree[key], f"{prefix}['{key}']").items()}
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", None)
        return {k: v for i, x in enumerate(tree)
                for k, v in port_flat(x, f"{prefix}.{names[i]}" if names
                                      else f"{prefix}[{i}]").items()}
    if dataclasses.is_dataclass(tree):
        return {k: v for f in dataclasses.fields(tree)
                for k, v in port_flat(getattr(tree, f.name), f"{prefix}.{f.name}").items()}
    return {prefix: tree}


def same_shapes(jtree, ptree):
    """Both trees' leaves: the same paths, shapes and dtypes."""
    j, p = jax_flat(jtree), port_flat(ptree)
    assert sorted(j) == sorted(p)
    for k in j:
        assert tuple(j[k].shape) == tuple(p[k].shape), k
        assert DTYPES[str(j[k].dtype)] == p[k].dtype, k


_EVAL_PARAMS = rtr.eval_params


@functools.lru_cache(maxsize=None)
def _jax_params(cfg):
    return _EVAL_PARAMS(jbuild_model(cfg))


class _Lowered:
    def __init__(self, fn, **kw):
        pass

    def lower(self, *args):
        return args


def reference_cell(monkeypatch, arch, shape, jmesh):
    """The reference's ``lower_cell`` arguments (ShapeDtypeStructs with
    shardings) and the model it built; ``eval_params`` cached per config."""
    built = []

    def build(cfg):
        built.append(jbuild_model(cfg))
        return built[-1]

    monkeypatch.setattr(jax, "jit", _Lowered)
    monkeypatch.setattr(rdr, "build_model", build)
    monkeypatch.setattr(rtr, "eval_params", lambda model, key=None: _jax_params(model.cfg))
    return rdr.lower_cell(arch, shape, jmesh), built[-1]


def spec(s):
    """A leaf's partition spec as a tuple (None for an unsharded leaf)."""
    return tuple(s.sharding.spec) if s.sharding is not None else ()


def test_arch_and_shape_registries_match():
    assert sorted(ARCHS) == sorted(JARCHS)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    for arch in ARCH_NAMES:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                jshape_applicable(jget_config(arch), JSHAPES[name])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_inputs_and_caches_match_the_reference(arch):
    """Every parameter leaf's shape, dtype and logical axes; every shape's
    inputs and decode cache (shapes and dtypes)."""
    params, axes = training.eval_params(build_model(get_config(arch)))
    jparams, jaxes = _jax_params(jget_config(arch))
    same_shapes(jparams, params)
    ja = jax_flat(jax.tree.map(lambda a: str(a), jaxes, is_leaf=lambda x: isinstance(x, tuple)))
    pa = port_flat(sh.tree_map2(lambda _, a: str(a), params, axes))
    assert ja == pa
    assert all(t.device.type == "meta" for t in port_flat(params).values())
    for name in SHAPES:
        same_shapes(jinput_specs(jget_config(arch), JSHAPES[name]),
                    input_specs(get_config(arch), SHAPES[name]))
        if SHAPES[name].kind == "decode" and shape_applicable(get_config(arch), SHAPES[name])[0]:
            same_shapes(jcache_specs(jget_config(arch), JSHAPES[name]),
                        cache_specs(get_config(arch), SHAPES[name]))


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cell_plans_match_the_reference(monkeypatch, arch, mesh_kind):
    """For every shape: the partition spec of every argument leaf (train
    state, params, batch, cache, token, position), the per-device argument
    bytes (the sum of the reference's ``shard_shape`` bytes), block_q and
    the residual, expert and context specs."""
    jmesh, mesh = MESHES[mesh_kind]
    for name in SHAPES:
        if not shape_applicable(get_config(arch), SHAPES[name])[0]:
            with pytest.raises(dryrun.SkipCell):
                dryrun.lower_cell(arch, name, mesh)
            continue
        jargs, jmodel = reference_cell(monkeypatch, arch, name, jmesh)
        plan = dryrun.lower_cell(arch, name, mesh)
        j, p = jax_flat(jargs), port_flat(plan.specs_in)
        assert sorted(j) == sorted(p)
        for k in j:
            assert tuple(j[k].shape) == p[k].shape, k
            assert DTYPES[str(j[k].dtype)] == p[k].dtype, k
            assert spec(j[k]) == tuple(p[k].sharding.spec), (name, k)
        jbytes = sum(math.prod(s.sharding.shard_shape(s.shape) if s.sharding else s.shape)
                     * s.dtype.itemsize for s in j.values())
        assert dryrun.spec_bytes(plan.specs_in) == jbytes
        assert plan.cfg.attention_block_q == jmodel.cfg.attention_block_q
        for mine, theirs in (("residual", jmodel.residual_sharding),
                             ("expert", jmodel.expert_sharding),
                             ("context", jmodel.context_sharding)):
            want = None if theirs is None else tuple(theirs.spec)
            assert (None if plan.specs[mine] is None else tuple(plan.specs[mine])) == want


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
def test_state_shardings_match_the_reference(mesh_kind):
    """``eval_train_state`` + ``state_shardings`` leaf for leaf (the moments
    follow the parameters), for every arch."""
    jmesh, mesh = MESHES[mesh_kind]
    for arch in ARCH_NAMES:
        state, axes = training.eval_train_state(build_model(get_config(arch)))
        jparams, jaxes = _jax_params(jget_config(arch))
        jstate = rtr.TrainState(params=jparams, opt=jax.eval_shape(rdr.adamw.init, jparams),
                                step=jax.ShapeDtypeStruct((), np.int32))
        same_shapes(jstate, state)
        j = jax_flat(rtr.state_shardings(jmesh, jstate, jaxes))
        p = port_flat(training.state_shardings(mesh, state, axes))
        assert {k: tuple(v.spec) for k, v in j.items()} == \
            {k: tuple(v.spec) for k, v in p.items()}


def test_teraagent_state_matches_the_reference(monkeypatch):
    """The TeraAgent cell: every state leaf's global shape and dtype, and the
    per-device bytes, on both meshes."""
    import repro.core.distributed as jdist

    class _Step:
        def lower(self, state):
            return state

    monkeypatch.setattr(jdist, "make_distributed_step", lambda *a, **k: _Step())
    for jmesh, mesh in MESHES.values():
        jstate = rdr.lower_teraagent(jmesh)
        plan = dryrun.lower_teraagent(mesh)
        # The plan holds the dataclass state as dicts of its fields.
        j = jax_flat(jstate)
        p = {re.sub(r"\['(\w+)'\]", r".\1", k): v for k, v in port_flat(plan.specs_in[0]).items()}
        assert sorted(j) == sorted(p)
        for k in j:
            assert (tuple(j[k].shape), DTYPES[str(j[k].dtype)]) == (p[k].shape, p[k].dtype), k
        jbytes = sum(math.prod(s.sharding.shard_shape(s.shape)) * s.dtype.itemsize
                     for s in j.values())
        assert dryrun.spec_bytes(plan.specs_in) == jbytes
        record = dryrun.run_cell("teraagent", "train_4k", "x", None, verbose=False, mesh=mesh)
        assert record["memory"]["argument_bytes"] == jbytes


def test_sharding_rules_match_the_reference_on_edge_shapes():
    """``spec_for_axes``' divisibility fallback, ``cache_sharding``'s three
    cases and ``activation_spec`` with and without sequence parallelism."""
    import repro.sharding as jsh

    for jmesh, mesh in MESHES.values():
        for shape, axes in [((48, 3072), ("embed", "mlp")), ((8, 100), ("kv", "vocab")),
                            ((64, 64, 64), ("experts", "embed", "mlp")),
                            ((5,), ("embed",)), ((32, 32), ("embed", "embed")),
                            ((4, 8), (None, "heads"))]:
            assert tuple(sh.spec_for_axes(mesh, shape, axes)) == \
                tuple(jsh.spec_for_axes(jmesh, shape, axes))
        for shape in [(32, 16, 64, 128), (32, 8, 32768, 128), (3, 8, 100, 64)]:
            assert tuple(sh.cache_sharding(mesh, shape, shape[1]).spec) == \
                tuple(jsh.cache_sharding(jmesh, shape, shape[1]).spec)
        for sp in (True, False):
            assert tuple(sh.activation_spec(mesh, sp)) == tuple(jsh.activation_spec(jmesh, sp))
        assert tuple(sh.batch_sharding(mesh).spec) == tuple(jsh.batch_sharding(jmesh).spec)
