"""The port's sharding spec trees and the dry run's spec arithmetic against
the JAX package, for every config of ``ARCH_IDS`` at its published
widths (config arithmetic only: the reference's ``jax.eval_shape`` trees
beside the port's meta-device trees; nothing is allocated).

Equal entry for entry (the reference's ``PartitionSpec`` as a tuple):

  * ``Model.param_specs`` and ``Model.cache_specs`` under no mesh (the
    default logical rules), and under each production mesh with
    ``arch_rules`` and every strategy of ``STRATEGIES`` on top;
  * ``_quantized_specs`` of the int8 serve tree;
  * ``batch_logical_axes``, ``arch_rules``, ``strategy_rules``,
    ``input_specs`` (shapes and dtypes) and ``batch_shardings`` for the
    four shapes;
  * ``local_bytes`` of the params, the optimizer state, the int8 tree and
    the decode caches: equal integers.

Every spec tree also matches the leaves of the port's ``init``,
``cache_init`` and ``quantize_params`` trees one for one (``local_bytes``
raises where it does not). The meshes are stand-ins with the production
axis names and sizes (the reference's ``AbstractMesh``; for the port an
object with ``mesh_dim_names`` and ``shape``): the specs read nothing
else of a mesh. ``tests/test_torch_dryrun.py`` builds the real meshes over
torch's fake process group.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.models.model import Model as JModel
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.parallel import sharding as jsharding
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.pytree import leaves
from repro_torch.launch import dryrun as tdry
from repro_torch.models.model import Model
from repro_torch.optim.adamw import make_optimizer
from repro_torch.parallel import sharding as tsharding
from _torch_threads import one_torch_thread  # noqa: F401

# The reference's dry run sets XLA_FLAGS for 512 host devices when it is
# imported. Bring this process's backend up first, with its own flags, and
# put the variable back, so that nothing else run here (or started from
# here) sees 512 devices.
jax.devices()
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}
#: every axis of the default rules, each of size 1
ONES = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                             shape=(1, 1, 1))


def _meshes(kind):
    names, shape = MESHES[kind]
    return (AbstractMesh(shape, names),
            types.SimpleNamespace(mesh_dim_names=names, shape=shape,
                                  size=lambda: int(np.prod(shape))))


def _ref(tree):
    """The reference's spec tree with every ``PartitionSpec`` as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    """The reference's abstract trees: params, int8 params, the decode
    cache of decode_32k."""
    m = JModel(jget_config(arch))
    params = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    qparams = jax.eval_shape(lambda p: m.quantize_params(p, 8), params)
    shape = JSHAPES["decode_32k"]
    cache = jax.eval_shape(
        lambda: m.cache_init(shape.global_batch, shape.seq_len))
    return m, params, qparams, cache


@functools.lru_cache(maxsize=None)
def _port_abstract(arch):
    m = Model(get_config(arch))
    params = m.init(None, device="meta")
    shape = SHAPES["decode_32k"]
    return (m, params, m.quantize_params(params, 8),
            m.cache_init(shape.global_batch, shape.seq_len, device="meta"))


def _rule_sets(arch, kind):
    """(label, reference rules, port rules) for a mesh kind: arch_rules of
    each shape's batch axes, with each strategy on top."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    jmesh, tmesh = _meshes(kind)
    out = []
    for shape_name in SHAPES:
        n = SHAPES[shape_name].global_batch
        jb, tb = jdry.batch_logical_axes(n, jmesh), \
            tdry.batch_logical_axes(n, tmesh)
        assert tb == jb, (shape_name, tb, jb)
        jr, tr = jdry.arch_rules(jcfg, jmesh, jb), tdry.arch_rules(cfg,
                                                                   tmesh, tb)
        assert tr == jr
        for strategy in tdry.STRATEGIES:
            js = jdry.strategy_rules(strategy, jcfg, jmesh, None)
            ts = tdry.strategy_rules(strategy, cfg, tmesh, None)
            assert ts == js, (strategy, ts, js)
            out.append((f"{shape_name}/{strategy}", {**jr, **js},
                        {**tr, **ts}))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_without_a_mesh_equal_the_reference(arch):
    jm, _, _, _ = _ref_abstract(arch)
    tm, params, qparams, cache = _port_abstract(arch)
    assert tm.param_specs() == _ref(jm.param_specs())
    assert tm.cache_specs() == _ref(jm.cache_specs())
    # leaf for leaf with the port's trees (local_bytes raises otherwise;
    # on a mesh of size 1 it counts every byte)
    for tree, specs in ((params, tm.param_specs()),
                        (cache, tm.cache_specs()),
                        (qparams, tdry._quantized_specs(
                            qparams, tm.param_specs()))):
        assert tdry.local_bytes(tree, specs, ONES) == sum(
            t.numel() * t.element_size() for t in leaves(tree))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_rules_and_local_bytes_under_every_strategy(arch):
    """Both meshes, every shape's batch axes and every strategy: the spec
    trees, the quantized ones and the per-device bytes of params, Adam's
    m and v, the int8 tree and the decode caches."""
    jm, jparams, jqparams, jcache = _ref_abstract(arch)
    tm, params, qparams, cache = _port_abstract(arch)
    jopt = jax.eval_shape(jmake_optimizer().init, jparams)
    opt = make_optimizer().init(params)
    for kind in MESHES:
        jmesh, tmesh = _meshes(kind)
        for label, jrules, trules in _rule_sets(arch, kind):
            with jsharding.use_mesh_rules(jmesh, jrules):
                jp, jc = jm.param_specs(), jm.cache_specs()
                jq = jdry._quantized_specs(jqparams, jp)
                want = [jdry.local_bytes(t, s, jmesh) for t, s in
                        ((jparams, jp), (jopt.m, jp), (jopt.v, jp),
                         (jqparams, jq), (jcache, jc))]
            with tsharding.use_mesh_rules(tmesh, trules):
                tp, tc = tm.param_specs(), tm.cache_specs()
                tq = tdry._quantized_specs(qparams, tp)
                got = [tdry.local_bytes(t, s, tmesh) for t, s in
                       ((params, tp), (opt.m, tp), (opt.v, tp),
                        (qparams, tq), (cache, tc))]
            assert tp == _ref(jp), (kind, label)
            assert tc == _ref(jc), (kind, label)
            assert tq == _ref(jq), (kind, label)
            assert got == want, (kind, label, got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_batch_shardings_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for kind in MESHES:
        jmesh, tmesh = _meshes(kind)
        for shape_name in SHAPES:
            shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
            want = jdry.input_specs(jcfg, jshape)
            got = tdry.input_specs(cfg, shape)
            assert list(got) == list(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape, (shape_name, k)
                assert got[k].device.type == "meta"
                assert (str(got[k].dtype).replace("torch.", "")
                        == str(jnp.dtype(want[k].dtype))), (shape_name, k)
            b = tdry.batch_logical_axes(shape.global_batch, tmesh)
            jsh = jdry.batch_shardings(jcfg, jshape, jmesh, b)
            assert tdry.batch_shardings(cfg, shape, tmesh, b) == {
                k: tuple(v.spec) for k, v in jsh.items()}, (kind, shape_name)


def test_combined_strategies_and_unknown_ones():
    cfg, jcfg = get_config("llama3-8b"), jget_config("llama3-8b")
    jmesh, tmesh = _meshes("multi")
    for spec in ("seqpar,fsdppod", "ep,tponly", "fsdp2d,seqpar"):
        assert tdry.combined_strategy_rules(spec, cfg, tmesh, None) == \
            jdry.combined_strategy_rules(spec, jcfg, jmesh, None)
    with pytest.raises(ValueError):
        tdry.strategy_rules("nope", cfg, tmesh, None)


def test_local_bytes_rejects_a_tree_it_does_not_match():
    m = Model(get_config("llama3-8b"))
    params = m.init(None, device="meta")
    specs = m.param_specs()
    specs["final_norm"] = {"weight": ()}
    with pytest.raises(ValueError):
        tdry.local_bytes(params, specs, ONES)
    with pytest.raises(ValueError):     # a spec longer than its leaf
        tdry.local_bytes({"w": torch.empty(3, device="meta")},
                         {"w": (None, None)}, ONES)
