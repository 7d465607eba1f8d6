"""The port's Cluster Builder against the JAX package's.

`build_topology` must give the reference's kernel graph for every
architecture of the registry (kernel for kernel, edge for edge), and
`build_plan` the reference's specs entry for entry — for params, paged
arenas and dense slot tables, in modes train, serve and serve_pipeline,
exact and not, on the production meshes and two small ones.  Both sides
get the same full-width shape trees (`jax.eval_shape`, no storage) and
abstract meshes; a JAX ``PartitionSpec`` is compared as the tuple it is.
Also: the port's `Sharding` cuts and joins a tensor as its spec says, and
`launch/mesh.py` lays shards out row-major.
"""
import functools

import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.configs import list_archs
from repro.core.cluster_builder import build_plan as jbuild_plan
from repro.core.cluster_builder import build_topology as jbuild_topology
from repro.launch.mesh import make_abstract_mesh as jabstract
from repro.models.transformer import init_params as jinit
from repro.models.transformer import make_model as jmake
from repro_torch.configs import get_config as tget
from repro_torch.core import cluster as tcl
from repro_torch.core.cluster_builder import Sharding, build_plan
from repro_torch.core.cluster_builder import build_topology
from repro_torch.launch.mesh import (make_abstract_mesh, make_mesh,
                                     make_production_mesh, required_devices)
from repro_torch.serving.kv_manager import paged_eligible

ARCHS = list_archs()
DECODERS = [a for a in ARCHS if a != "ibert-base"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x8": ((1, 8), ("data", "model"))}
STAGE_MESH = ((4,), ("stage",))


def _kernels(topo):
    return [[(k.cluster_id, k.local_id, k.kind, k.op, k.meta)
             for k in c.kernels] for c in topo.clusters]


@pytest.mark.parametrize("arch", ARCHS)
def test_topology_matches_jax(arch):
    want, got = jbuild_topology(jget(arch)), build_topology(tget(arch))
    assert _kernels(got) == _kernels(want)
    assert got.edges == want.edges
    assert got.routing_entries_per_device() == \
        want.routing_entries_per_device()
    assert got.routing_entries_flat() == want.routing_entries_flat()
    assert got.total_kernels == want.total_kernels


def test_ibert_cluster_is_fig14():
    """One encoder cluster of 38 kernels (paper §9.4), six of them GMI or
    gateway kernels, 12 clusters chained through their gateways."""
    topo = build_topology(tget("ibert-base"))
    assert len(topo.clusters) == 12
    c = topo.clusters[0]
    assert len(c.kernels) == 38
    assert sum(k.kind in ("gmi", "gateway") for k in c.kernels) == 6
    assert tcl.max_addressable_kernels() == 65536
    with pytest.raises(ValueError):
        big = tcl.ClusterTopology().new_cluster()
        for _ in range(tcl.MAX_KERNELS_PER_CLUSTER):
            big.add("compute")


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """Full-width shape trees: params, and (where the arch serves paged)
    a bf16 and an int8 arena, and dense caches at serving and at
    decode_32k size."""
    cfg = jget(arch)
    model = jmake(cfg, remat=False)
    out = {"params": jax.eval_shape(
        lambda k: jinit(cfg, k), jax.ShapeDtypeStruct((2,), jnp.uint32))}
    if paged_eligible(tget(arch)):
        for kv in ("bf16", "int8"):
            out[f"arena_{kv}"] = jax.eval_shape(
                lambda kv=kv: model.init_paged_cache(4, 64, 16, 8,
                                                     kv_dtype=kv))
    out["slots"] = jax.eval_shape(lambda: model.init_cache(4, 64))
    out["big"] = jax.eval_shape(lambda: model.init_cache(128, 32768))
    return out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _same(want, got):
    w, g = dict(_flat(want)), dict(_flat(got))
    assert w.keys() == g.keys()
    for path in w:
        assert tuple(w[path]) == tuple(g[path]), (path, w[path], g[path])


CASES = ([(m, mode, exact) for m in MESHES for mode in ("train", "serve")
          for exact in (True, False)]
         + [("4", "serve_pipeline", exact) for exact in (True, False)])


@pytest.mark.parametrize("arch", DECODERS)
@pytest.mark.parametrize("mesh_name,mode,exact", CASES)
def test_plan_specs_match_jax(arch, mesh_name, mode, exact):
    shape, axes = MESHES.get(mesh_name, STAGE_MESH)
    jplan = jbuild_plan(jget(arch), jabstract(shape, axes), mode=mode,
                        exact=exact)
    plan = build_plan(tget(arch), make_abstract_mesh(shape, axes), mode=mode,
                      exact=exact)
    assert plan.fsdp == jplan.fsdp and plan.mode == jplan.mode
    assert (plan.axes.dp, plan.axes.tp, plan.axes.stage) == (
        jplan.axes.dp, jplan.axes.tp, jplan.axes.stage)
    trees = _shapes(arch)
    _same(jplan.specs_for_params(trees["params"]),
          plan.specs_for_params(trees["params"]))
    for name, tree in trees.items():
        if name.startswith("arena"):
            _same(jplan.specs_for_caches(tree, batch=4, paged=True),
                  plan.specs_for_caches(tree, batch=4, paged=True))
        elif name != "params":
            for slot_table in (True, False):
                kw = dict(batch=tree["pos"].shape[0], slot_table=slot_table)
                _same(jplan.specs_for_caches(tree, **kw),
                      plan.specs_for_caches(tree, **kw))
    for ndim, b in ((2, 1), (2, 256), (3, 32)):
        assert tuple(plan.data_spec(ndim, b)) == tuple(
            jplan.data_spec(ndim, b))


def test_build_plan_with_trees_and_batch():
    """build_plan(params_shape, caches_shape, batch) fills the plan's
    specs as the reference's does."""
    arch = "smollm-135m"
    trees = _shapes(arch)
    args = dict(params_shape=trees["params"], caches_shape=trees["slots"],
                batch=256, mode="train")
    shape, axes = MESHES["16x16"]
    jplan = jbuild_plan(jget(arch), jabstract(shape, axes), **args)
    plan = build_plan(tget(arch), make_abstract_mesh(shape, axes), **args)
    _same(jplan.param_specs, plan.param_specs)
    _same(jplan.cache_specs, plan.cache_specs)
    with pytest.raises(ValueError, match="stage"):
        build_plan(tget(arch), make_abstract_mesh((1, 8), ("data", "model")),
                   mode="serve_pipeline")


@pytest.mark.parametrize("spec", [(None, "model"), ("model", None),
                                  (("data", "model"), None),
                                  ("data", "model"), (None, None)])
def test_sharding_split_and_join(spec):
    mesh = make_mesh((2, 3), ("data", "model"), device="cpu")
    t = torch.arange(12 * 6, dtype=torch.float32).reshape(12, 6)
    sh = Sharding(mesh, spec)
    parts = sh.split(t)
    assert len(parts) == 6
    for f, p in enumerate(parts):
        c = mesh.coords(f)
        want = t
        for dim, e in enumerate(spec):
            axes = () if e is None else ((e,) if isinstance(e, str) else e)
            if axes:
                n = mesh.axis_size(axes)
                i = mesh.axis_index(f, axes)
                w = want.shape[dim] // n
                want = want.narrow(dim, i * w, w)
        assert torch.equal(p, want), (f, c)
    assert torch.equal(sh.join(parts), t)
    if spec == (None, None):  # replicated on one device: one tensor
        assert all(p is parts[0] for p in parts)


def test_mesh_layout():
    mesh = make_mesh((2, 4), ("pod", "data"), device="cpu")
    assert mesh.shape == {"pod": 2, "data": 4} and mesh.size == 8
    assert mesh.coords(6) == {"pod": 1, "data": 2}
    assert mesh.groups("data") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.groups("pod") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert mesh.axis_index(6, ("pod", "data")) == 6
    assert mesh.shared_devices()
    assert make_abstract_mesh((16, 16), ("data", "model")).abstract
    assert required_devices() == 256 and required_devices(True) == 512
    with pytest.raises(ValueError):
        make_mesh((2,), ("x",), device="meta")


def test_make_mesh_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 2), ("data", "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()
