"""The port's sharding rules (``repro_torch.distributed.sharding``,
``models.moe.moe_param_specs``) against the reference's PartitionSpecs,
exactly, for every config and three shape-only meshes (2 x 2, 16 x 16
and 2 x 16 x 16 with a 'pod' axis): no ranks, the shapes from the
port's ``init_params`` / ``init_cache`` on the meta device and the
reference's ``jax.eval_shape``.

A spec of the port is ``tuple(PartitionSpec)``. The reference stacks
the scanned layers (``stack``, a leading None in each spec); the port
keeps a dict a layer, so a layer leaf's spec is compared with the
reference's without that entry (prefix layers, kimi-k2's ``prefix0``,
have none). ZeRO-2's moment specs are compared leaf by leaf through the
reference's ``opt_extra_shard`` on the port's (un-stacked) leaf: the
stack dimension it may pick has no counterpart here.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.distributed import sharding as jshd
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.core.tree import get, paths
from repro_torch.distributed import sharding as tshd
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe

ARCHS = list(tconfigs.ARCH_IDS)
MESHES = {"2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _dists(mesh):
    class FakeMesh:
        shape = MESHES[mesh]
    axes = ("pod", "data") if "pod" in MESHES[mesh] else ("data",)
    return (jmoe.DistContext(mesh=FakeMesh(), data_axes=axes,
                             model_axis="model"),
            tmoe.DistContext(mesh=FakeMesh(), data_axes=axes,
                             model_axis="model"))


def _spec_leaves(tree):
    """(path, spec) of a port spec tree (a spec is a tuple leaf)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for p, s in _spec_leaves(tree[k]):
                yield (k,) + p, s
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            for p, s in _spec_leaves(v):
                yield (i,) + p, s
    else:
        yield (), tree


def _ref_of(cfg, ref_tree, path):
    """The reference's spec of the port's leaf at ``path``, the stack
    entry of a stacked layer's dropped."""
    if path[0] != "layers":
        return ref_tree[path[0]] if len(path) == 1 else get(ref_tree, path)
    i, rest = path[1], path[2:]
    n_prefix, _, period = TM.stack_plan(cfg)
    if i < n_prefix:
        return get(ref_tree[f"prefix{i}"], rest)
    spec = get(ref_tree["stack"][f"sub{(i - n_prefix) % period}"], rest)
    assert spec[0] is None
    return P(*spec[1:])


@functools.lru_cache(maxsize=None)
def _params(arch, mesh, **over):
    cfg = dataclasses.replace(jconfigs.get_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_config(arch), **over)
    jd, td = _dists(mesh)
    jspecs, _ = jshd.param_specs(cfg, jd)
    tspecs, tshapes = tshd.param_specs(tcfg, td)
    return cfg, tcfg, jd, td, jspecs, tspecs, tshapes


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    cfg, tcfg, _, _, jspecs, tspecs, tshapes = _params(arch, mesh)
    got = list(_spec_leaves(tspecs))
    assert [p for p, _ in got] == [p for p, _ in paths(tshapes)]
    n_ref = len(jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, P)))
    assert n_ref == len(jax.tree.leaves(jax.eval_shape(
        lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))))
    for path, spec in got:
        assert isinstance(spec, tuple)
        assert spec == tuple(_ref_of(tcfg, jspecs, path)), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zero2_moment_specs_equal_the_reference(arch, mesh):
    cfg, tcfg, jd, td, jspecs, tspecs, tshapes = _params(arch, mesh, zero=2)
    flat = list(_spec_leaves(tspecs))
    # ZeRO-2: no parameter spec names 'data' (the experts' layout is
    # moe_param_specs' whatever the ZeRO stage)
    if not cfg.n_experts:
        assert not any("data" in str(s) for _, s in flat)
    for (path, spec), (_, shape) in zip(flat, paths(tshapes)):
        want = jshd.opt_extra_shard(
            cfg, jd, P(*spec), jax.ShapeDtypeStruct(tuple(shape.shape),
                                                    jnp.float32))
        got = tshd.opt_extra_shard(tcfg, td, spec, shape)
        assert got == tuple(want), path
    if arch == "granite-34b" and mesh == "16x16":
        # the reference's own pin (tests/test_perf_paths.py)
        sp = tshd.opt_extra_shard(tcfg, td, (None, "model"), (6144, 24576))
        assert "data" in str(sp)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_and_logits_specs_equal_the_reference(arch, mesh):
    cfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jd, td = _dists(mesh)
    n_cells = 0
    for jcell, tcell in zip(jconfigs.cells_for(cfg), tconfigs.cells_for(tcfg)):
        assert jcell.arch == tcell.arch and jcell.run == tcell.run
        if not tcell.run:
            continue
        n_cells += 1
        jb, jshapes = jshd.batch_specs(cfg, jcell.shape, jd)
        tb, tshapes = tshd.batch_specs(tcfg, tcell.shape, td)
        assert sorted(tb) == sorted(jb)
        for k in tb:
            assert tb[k] == tuple(jb[k]), k
            assert tuple(tshapes[k].shape) == jshapes[k].shape, k
        if tcell.shape.kind == "decode":
            jc, _ = jshd.cache_specs(cfg, jcell.shape, jd)
            tc, tcache = tshd.cache_specs(tcfg, tcell.shape, td)
            assert tc["pos_offset"] == tuple(jc["pos_offset"])
            got = [(p, s) for p, s in _spec_leaves(tc)
                   if p[0] == "layers"]
            assert [p for p, _ in got] == [p for p, _ in paths(tcache)
                                           if p[0] == "layers"]
            for path, spec in got:
                assert spec == tuple(_ref_of(tcfg, jc, path)), \
                    (tcell.shape.name, path)
        for gb in (None, tcell.shape.global_batch):
            assert tshd.logits_spec(tcfg, td, gb) == \
                tuple(jshd.logits_spec(cfg, jd, gb))
    assert n_cells >= 2


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("ep", [True, False])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b",
                                  "kimi-k2-1t-a32b"])
def test_moe_param_specs_and_mode_equal_the_reference(arch, ep, mesh):
    cfg = dataclasses.replace(jconfigs.get_config(arch), expert_parallel=ep)
    tcfg = dataclasses.replace(tconfigs.get_config(arch), expert_parallel=ep)
    jd, td = _dists(mesh)
    assert tmoe.ep_mode(tcfg, td) == jmoe.ep_mode(cfg, jd)
    want = jmoe.moe_param_specs(cfg, jd)
    got = tmoe.moe_param_specs(tcfg, td)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k] == tuple(want[k]), k
    assert (td.model_size, td.data_size) == (jd.model_size, jd.data_size)
