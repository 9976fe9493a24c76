"""The port's sharding rules against the reference's, entry for entry.

For every registered architecture (full and smoke) on the production
meshes (16×16 and 2×16×16): ``param_pspecs`` under both rule sets,
``cache_pspecs``, ``batch_pspec``, ``derive_ctx``, ``input_specs`` and
``input_shardings`` of every input shape. The reference's rule functions
read only ``mesh.shape``, so they run on a ``jax.sharding.AbstractMesh``
(no devices); the port's on its shape-only ``MeshShape``.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps
from repro.models.mesh_ctx import MeshCtx as JaxCtx
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import INPUT_SHAPES as TORCH_SHAPES
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.launch import steps as tsteps
from repro_torch.models.mesh_ctx import MeshCtx as TorchCtx
from repro_torch.models.transformer import Model

MESHES = {"16x16": False, "2x16x16": True}
NAMES = [a + s for a in ALL_ARCHS for s in ("", "-smoke")]


def _jax_mesh(multi_pod: bool):
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _key(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _jax_flat(tree, leaf=lambda x: isinstance(x, PartitionSpec)):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]
    return {_key(p): v for p, v in flat}


def _torch_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_torch_flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        out = {}
        for i, v in enumerate(tree):
            out.update(_torch_flat(v, f"{prefix}.{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def _same_specs(jtree, ttree):
    want = {k: tuple(v) for k, v in _jax_flat(jtree).items()}
    got = {k: tuple(v) for k, v in _torch_flat(ttree).items()}
    assert sorted(got) == sorted(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


def _same_shapes(jtree, ttree):
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _jax_flat(
                jtree, lambda x: isinstance(x, jax.ShapeDtypeStruct)).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in _torch_flat(ttree).items()}
    assert got == want


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """(reference model on a 1×1 context, its eval_shape'd params)."""
    mesh = AbstractMesh((1, 1), ("data", "model"))
    model = jax_build_model(jax_get_config(name), JaxCtx(mesh=mesh))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_rules_equal_reference(name, mesh_name):
    multi_pod = MESHES[mesh_name]
    jmesh = _jax_mesh(multi_pod)
    tm = tmesh.make_production_mesh(multi_pod=multi_pod)
    assert dict(tm.shape) == dict(jmesh.shape)
    jmodel, jshape = _reference(name)
    cfg = torch_get_config(name)
    tspec = Model(cfg).param_spec()
    # parameters, both rule sets (the stacked ``blocks`` dim unsharded)
    for jr, tr in ((None, None), (jshd.DECODE_RULES, tshd.DECODE_RULES)):
        _same_specs(jshd.param_pspecs(jshape, jmesh, jr),
                    tshd.param_pspecs(tspec, tm, tr))
    for shape_name, jshape_in in JAX_SHAPES.items():
        tshape_in = TORCH_SHAPES[shape_name]
        jctx = jsteps.derive_ctx(jmesh, jshape_in, jmodel.cfg, multi_pod)
        tctx = tsteps.derive_ctx(tm, tshape_in, cfg, multi_pod)
        assert isinstance(tctx, TorchCtx)
        assert (tctx.batch_axes, tctx.moe_impl, tctx.remat, tctx.bspec,
                tctx.dp_size, tctx.tp_size) == (
                    tuple(jctx.batch_axes), jctx.moe_impl, jctx.remat,
                    jctx.bspec, jctx.dp_size, jctx.tp_size)
        B, S = tshape_in.global_batch, tshape_in.seq_len
        assert tuple(tshd.batch_pspec(tctx, B)) == tuple(
            jshd.batch_pspec(jctx, B))
        tmodel = Model(cfg, ctx=tctx)
        _same_shapes(jsteps.input_specs(jmodel.cfg, jshape_in, jmodel, jctx),
                     tsteps.input_specs(cfg, tshape_in, tmodel, tctx))
        jsh = jax.tree.map(lambda s: s.spec, jsteps.input_shardings(
            jmodel.cfg, jshape_in, jmodel, jctx))
        _same_specs(jsh, tsteps.input_shardings(cfg, tshape_in, tmodel,
                                                tctx))
        if tshape_in.kind == "decode":
            # the decode cache's specs, and with shard_kv_seq off
            for kw in ({}, {"shard_kv_seq": False}):
                jc = jctx if not kw else type(jctx)(
                    **{**jctx.__dict__, **kw})
                tc = tsteps.derive_ctx(tm, tshape_in, cfg, multi_pod, **kw)
                _same_specs(jshd.cache_pspecs(jmodel.cache_spec(B, S), jc),
                            tshd.cache_pspecs(tmodel.cache_spec(B, S), tc))


def test_mesh_helpers_and_spec_leaves():
    m = tmesh.make_mesh_for(8, 2)
    assert dict(m.shape) == {"data": 4, "model": 2} and m.comm is None
    assert dict(tmesh.make_mesh_for(4, 9).shape) == {"data": 1, "model": 4}
    # a spec is a leaf of the trees the port walks, and compares as a
    # PartitionSpec does
    sp = tshd.PSpec(None, ("data", "model"))
    assert tuple(sp) == tuple(PartitionSpec(None, ("data", "model")))
    assert sp.entry(5) is None
    # the shape-only mesh refuses a collective over an axis with ranks
    ctx = TorchCtx(mesh=tmesh.make_production_mesh())
    with pytest.raises(RuntimeError, match="live mesh"):
        ctx.psum(torch.ones(2), "model")
    # and is the identity over size-1 axes, launching nothing
    one = TorchCtx(mesh=tmesh.make_mesh_for(1))
    t = torch.arange(4.0)
    assert one.psum(t, "model") is t and one.all_gather(t, "data") is t
    assert one.axis_index(("data", "model")) == 0


@pytest.mark.parametrize("name", ["deepseek-v3-671b-smoke",
                                  "recurrentgemma-2b-smoke"])
def test_init_is_a_function_of_the_seed(name, monkeypatch):
    """``Model.init(seed)`` draws every slice on the CPU from its own
    generator: equal across calls and thread counts (and so on every
    device, which the card's stage R0 checks bit for bit); another seed
    differs. Small slices, so the leaves take many, drawn on the pool."""
    import dataclasses

    from repro_torch.models import common
    from repro_torch.models.common import tree_leaves

    monkeypatch.setattr(common, "_FILL_ELEMS", 4096)
    monkeypatch.setattr(common, "_HOST_ELEMS", 4096)
    cfg = dataclasses.replace(torch_get_config(name), dtype="float32")
    m = Model(cfg)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = tree_leaves(m.init(3, device="cpu"))
        torch.set_num_threads(4)
        four = tree_leaves(m.init(3, device="cpu"))
    finally:
        torch.set_num_threads(threads)
    assert len(one) == len(four)
    assert all(torch.equal(a, b) for a, b in zip(one, four))
    other = tree_leaves(m.init(4, device="cpu"))
    assert not all(torch.equal(a, b) for a, b in zip(one, other)
                   if a.abs().sum() > 0)
