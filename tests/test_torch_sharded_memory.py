"""Llama-3.2-Vision-11B (cross-attention to patch embeddings) and
SeamlessM4T-medium (an encoder, then cross-attention to its output)
served on meshes over gloo ranks, against the reference on the same
Auto-axis meshes (``tests/torch_mesh_serving.py``).

The VLM's smoke memory is 17 patches, which do not divide a 2-rank
sequence axis: its cross K/V stay whole on every rank (the full model's
1601 patches), each rank attending with its own heads. SeamlessM4T's 16
frames divide it: its cross K/V are cut along the sequence and decode
combines the ranks' partial outputs; its encoder runs heads and MLP over
TP with the sequence-parallel residual.

* ``Model.prefill`` and three ``decode_step``s on (2,1), (1,2) and
  (2,2), with and without ``shard_kv_seq``, in float32: logits within
  1e-4 relative of the reference's, identical on every rank; in
  bfloat16 on (2,2) within 0.08 of the reference's float32 logits.
* ``FlowServeEngine(ctx=, memory=)`` on (2,1), (1,2) and (2,2): the
  reference's greedy tokens on every rank.
* A live mesh of one rank: bit for bit the one-device path.
* The decode layout of the memory's K/V (``Model.mem_axis``,
  ``slot_axis``) and the specs of the steps' inputs against the
  reference's on the small meshes.
"""
from __future__ import annotations

import numpy as np
import pytest

import torch_mesh_serving as tms
from torch_mesh import rel_err

CONFIGS = {
    # 8 heads on 2 KV heads (G 4, as at full width), 17 patches
    "vision": ("llama-3.2-vision-11b-smoke",
               {"num_heads": 8, "num_kv_heads": 2,
                "num_frontend_tokens": 17}),
    # a 2-block encoder over 16 frames, then (ATTN, NONE), (CROSS_ATTN,
    # MLP)
    "seamless": ("seamless-m4t-medium-smoke", {}),
}
CASES = [(n, m) for n in CONFIGS for m in tms.MESHES]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return tms.run(tmp_path_factory, __name__, CONFIGS)


def _steps():
    return ["prefill"] + [f"decode{i}" for i in range(tms.STEPS)]


@pytest.mark.parametrize("name,mesh", CASES)
def test_logits_match_reference_on_mesh(both, name, mesh):
    want, got = both
    for k in _steps():
        key = f"{name}/{mesh}/{k}"
        err = rel_err(got[0][key], want[key])
        assert err < 1e-4, (key, err)
        for g in got[1:]:
            np.testing.assert_array_equal(g[key], got[0][key])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_logits_within_bar(both, name):
    want, got = both
    for k in _steps():
        key = f"{name}/bf16/{k}"
        err = rel_err(got[0][key], want[f"{name}/{tms.BF16_MESH}/{k}"])
        assert err < 0.08, (key, err)
        for g in got[1:]:
            np.testing.assert_array_equal(g[key], got[0][key])


@pytest.mark.parametrize("mesh", tms.ENGINE_MESHES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_tokens_match_reference_on_every_rank(both, name, mesh):
    want, got = both
    ref = want[f"{name}/engine"].tolist()
    assert all(len(t) == tms.NEW for t in ref)
    for g in got:
        assert g[f"{name}/engine/{mesh}"] == ref


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world_size_one_is_the_one_device_path(both, name):
    _, got = both
    for g in got:
        assert g[f"{name}/world1"] is True
        assert g[f"{name}/world1/engine"] is True
        assert {"all_gather", "psum"} <= set(g[f"{name}/sent"])


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_memory_layout_and_input_specs_equal_reference(name, shape):
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jax_get_config
    from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
    from repro.launch import sharding as jshd
    from repro.launch import steps as jsteps
    from repro.models.mesh_ctx import MeshCtx as JaxCtx
    from repro.models.transformer import build_model as jax_build_model
    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.mesh_ctx import MeshCtx, MeshShape
    from repro_torch.models.transformer import Model

    from test_torch_sharding import _same_specs

    cfg = tms.config(get_config, CONFIGS, name)
    jcfg = tms.config(jax_get_config, CONFIGS, name)
    jmesh = AbstractMesh(shape, ("data", "model"))
    tmesh = MeshShape(shape, ("data", "model"))
    for seq in (True, False):
        for kind, jin in JAX_SHAPES.items():
            tin = INPUT_SHAPES[kind]
            jctx = jsteps.derive_ctx(jmesh, jin, jcfg, False,
                                     shard_kv_seq=seq)
            tctx = tsteps.derive_ctx(tmesh, tin, cfg, False,
                                     shard_kv_seq=seq)
            jm, tm = jax_build_model(jcfg, jctx), Model(cfg, ctx=tctx)
            _same_specs(jax.tree.map(lambda s: s.spec,
                                     jsteps.input_shardings(jcfg, jin, jm,
                                                            jctx)),
                        tsteps.input_shardings(cfg, tin, tm, tctx))
        # the decode layout: the memory's slots cut exactly where the
        # reference's cache_pspecs cut them
        ctx = MeshCtx(mesh=tmesh, shard_kv_seq=seq)
        m = Model(cfg, ctx=ctx)
        jctx = JaxCtx(mesh=jmesh, shard_kv_seq=seq)
        specs = jshd.cache_pspecs(jax_build_model(jcfg, jctx).cache_spec(
            4, 48), jctx)
        flat = {tuple(getattr(k, "key", getattr(k, "idx", None))
                      for k in p): v for p, v in
                jax.tree_util.tree_flatten_with_path(
                    specs, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]}
        for keys, sp in flat.items():
            if keys[-1] in ("k", "v"):
                dim = 2 if "blocks" in keys else 1
                want = sp[dim] if dim < len(sp) else None
                if want is not None and dict(jmesh.shape)[want] == 1:
                    want = None              # a 1-rank axis cuts nothing
                assert m.slot_axis(keys) == want, (keys, sp)
