"""The whole model and the serving engine on meshes over gloo ranks, in
f32, against the reference on the same mesh.

* ``Model.prefill``, ``prefill_chunk`` (two chunks into one buffer) and
  three ``decode_step``s of the DeepSeek-V3 and Llama-4 smoke models on
  (2,2), (1,2) and (2,1), and on (2,2) under ``DECODE_RULES`` with EP
  over both axes: logits within 1e-4 relative of the reference's, each
  rank holding only its blocks of the reference's weights
  (``from_jax_params(ctx=)``), identical on every rank.
* ``FlowServeEngine(ctx=)``: greedy tokens equal to the reference's
  ``FlowServeEngine(ctx=)`` and identical on every rank. The reference's
  engine runs on (1,2): on a mesh with two data ranks its
  batch-1 prefill does not divide the data axis and ``shard_map``
  raises; the port replicates such a batch (``batch_pspec``), so its
  (2,2) and (2,1) engines are held to the reference's (1,2) (capacity
  factor 8: no assignment drops on either mesh).
* World size 1 with a live gloo group (a (1,1) mesh, one replica per
  rank): the mesh code path is bit-identical to the one-device path.

The smaller meshes run on the 4 ranks of one world as replicas along a
leading axis ``r`` that no collective names.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_mesh import Reference, rel_err

CONFIGS = {"deepseek-v3": ("deepseek-v3-671b-smoke", {}),
           "llama4": ("llama4-maverick-400b-a17b-smoke", {})}
#: name → (reference mesh, EP axis, decode rules)
MESHES = {"2x2": ((2, 2), "model", False),
          "1x2": ((1, 2), "model", False),
          "2x1": ((2, 1), "model", False),
          "2x2/decode-rules": ((2, 2), ("data", "model"), True)}
#: the meshes each configuration runs on (EP over both axes: the MoE
#: of DeepSeek-V3)
MESHES_OF = {"deepseek-v3": list(MESHES),
             "llama4": ["2x2", "1x2", "2x1"]}
#: port mesh → the reference engine's mesh
ENGINES = {"2x2": (1, 2), "1x2": (1, 2), "2x1": (1, 2)}
B, S, L, STEPS = 4, 16, 32, 3
PROMPTS = ["hello world", "the quick brown fox jumps", "a"]


def config(get_config, name):
    import dataclasses

    arch, kw = CONFIGS[name]
    return dataclasses.replace(get_config(arch), dtype="float32", **kw)


def _inputs(vocab):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    dec = rng.integers(0, vocab, (STEPS, B, 1)).astype(np.int32)
    return toks, dec


REFERENCE = """
from repro.configs import get_config
from repro.models.mesh_ctx import MeshCtx
from repro.models.transformer import build_model
from repro.serving.flowserve import FlowServeEngine
from repro.serving.request import Request
from test_torch_sharded_model import (CONFIGS, ENGINES, MESHES, MESHES_OF,
                                      PROMPTS, B, S, L, STEPS, _inputs,
                                      config)
ctx1 = MeshCtx(mesh=auto_mesh((1, 1)), batch_axes=("data",), remat="none")
weights = {}
for name in CONFIGS:
    weights[name] = jax.jit(build_model(config(get_config, name),
                                        ctx1).init)(jax.random.PRNGKey(0))
    for n, a in jax.tree_util.tree_flatten_with_path(weights[name])[0]:
        put(f"{name}/param/" + ".".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in n), a)
publish("params")
for name in CONFIGS:
    cfg = config(get_config, name)
    toks, dec = _inputs(cfg.vocab_size)
    params = weights[name]
    for mname, (shape, ep, _) in MESHES.items():
        if mname not in MESHES_OF[name]:
            continue
        ctx = MeshCtx(mesh=auto_mesh(shape), batch_axes=("data",),
                      remat="none", ep_axis=ep)
        m = build_model(cfg, ctx)
        key = f"{name}/{mname}"
        lp, _ = jax.jit(m.prefill)(params, jnp.asarray(toks))
        put(key + "/prefill", lp)
        cache = m.init_cache(B, L)
        chunk = jax.jit(m.prefill_chunk)
        half = S // 2
        _, cache = chunk(params, cache, jnp.asarray(toks[:, :half]),
                         jnp.int32(0), jnp.full((B,), half - 1, jnp.int32))
        lc, cache = chunk(params, cache, jnp.asarray(toks[:, half:]),
                          jnp.int32(half),
                          jnp.full((B,), half - 1, jnp.int32))
        put(key + "/chunk", lc)
        step = jax.jit(m.decode_step)
        for i in range(STEPS):
            ld, cache = step(params, cache, jnp.asarray(dec[i]),
                             jnp.full((B,), S + i, jnp.int32))
            put(key + f"/decode{i}", ld)
    for eshape in sorted(set(ENGINES.values())):
        ctx = MeshCtx(mesh=auto_mesh(eshape), batch_axes=("data",),
                      remat="none")
        eng = FlowServeEngine(cfg, params, ctx=ctx, n_dp_groups=2,
                              max_batch=2, max_len=64)
        reqs = [Request(prompt=p, max_new_tokens=6, ignore_eos=True)
                for p in PROMPTS]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        eng.close()
        put(f"{name}/engine/{eshape}", np.asarray(
            [list(r.output_tokens) for r in reqs], np.int32))
"""


def _port_mesh(shape):
    if shape[0] * shape[1] == 4:
        return shape, ("data", "model")
    return (4 // (shape[0] * shape[1]),) + shape, ("r", "data", "model")


def _run_model(m, params, toks, dec):
    out = {}
    lp, _ = m.prefill(params, toks)
    out["prefill"] = lp.numpy()
    cache = m.init_cache(B, L, device="cpu")
    half = S // 2
    last = torch.full((B,), half - 1)
    _, cache = m.prefill_chunk(params, cache, toks[:, :half], 0, last)
    lc, cache = m.prefill_chunk(params, cache, toks[:, half:], half, last)
    out["chunk"] = lc.numpy()
    cache = m.place_cache(cache, B)
    for i in range(STEPS):
        ld, cache = m.decode_step(params, cache, dec[i],
                                  torch.full((B,), S + i, dtype=torch.int32))
        out[f"decode{i}"] = ld.numpy()
    return out


def _serve(cfg, params, ctx, rules=None):
    from repro_torch.serving.flowserve import FlowServeEngine
    from repro_torch.serving.request import Request

    eng = FlowServeEngine(cfg, params, device="cpu", ctx=ctx, rules=rules,
                          n_dp_groups=2, max_batch=2, max_len=64)
    reqs = [Request(prompt=p, max_new_tokens=6, ignore_eos=True)
            for p in PROMPTS]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    eng.close()
    return [list(r.output_tokens) for r in reqs]


def _rank(rank, world, init, flat_params):
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import from_jax_params

    out, meshes = {}, {}

    def mesh(shape):
        pshape, names = _port_mesh(shape)
        if pshape not in meshes:
            meshes[pshape] = init_mesh(pshape, "gloo", "cpu",
                                       axis_names=names, rank=rank,
                                       world_size=world, init_method=init)
        return meshes[pshape]
    for name in CONFIGS:
        cfg = config(get_config, name)
        toks, dec = (torch.from_numpy(a).long()
                     for a in _inputs(cfg.vocab_size))
        flat = flat_params[name]
        for mname, (shape, ep, drules) in MESHES.items():
            if mname not in MESHES_OF[name]:
                continue
            rules = shd.DECODE_RULES if drules else None
            ctx = MeshCtx(mesh=mesh(shape), batch_axes=("data",),
                          remat="none", ep_axis=ep)
            m = Model(cfg, ctx=ctx, rules=rules)
            params = from_jax_params(flat, cfg, "cpu", ctx=ctx, rules=rules)
            for k, v in _run_model(m, params, toks, dec).items():
                out[f"{name}/{mname}/{k}"] = v
            if mname in ENGINES:
                out[f"{name}/engine/{mname}"] = _serve(cfg, params, ctx)
        # world size 1 with a live group, the mesh code path: bit for bit
        # the one-device path
        one = MeshCtx(mesh=mesh((1, 1)), batch_axes=("data",), remat="none")
        m1 = Model(cfg, ctx=one)
        assert m1.sharded
        p1 = from_jax_params(flat, cfg, "cpu", ctx=one)
        m0 = Model(cfg)
        p0 = from_jax_params(flat, cfg, "cpu")
        a, b = _run_model(m1, p1, toks, dec), _run_model(m0, p0, toks, dec)
        out[f"{name}/world1"] = all(np.array_equal(a[k], b[k]) for k in a)
        out[f"{name}/world1/engine"] = (_serve(cfg, p1, one)
                                        == _serve(cfg, p0, None))
        out[f"{name}/sent"] = dict(meshes[(2, 2)].comm.sent)
        # the seeded init on a mesh: each rank's blocks of the one-device
        # weights, under both rule sets
        whole = Model(cfg).init(5, device="cpu")
        for rules in (None, shd.DECODE_RULES):
            ctx = MeshCtx(mesh=mesh((2, 2)), batch_axes=("data",))
            mm = Model(cfg, ctx=ctx, rules=rules)
            got = mm.init(5, device="cpu")
            want = shd.shard_tree(whole, mm.specs, ctx)
            out[f"{name}/init/{rules is None}"] = all(
                torch.equal(a, b) for a, b in zip(
                    _leaves(got), _leaves(want)))
    return out


def _leaves(tree):
    from repro_torch.models.common import tree_leaves

    return tree_leaves(tree)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    # the ranks start once the reference has published its weights, and
    # run while it computes the rest
    ref = Reference(tmp_path_factory.mktemp("ref"), REFERENCE, timeout=900)
    params = ref.part("params")
    flat = {name: {k[len(name) + 7:]: v for k, v in params.items()
                   if k.startswith(f"{name}/param/")} for name in CONFIGS}
    got = spawn(_rank, 4, flat, threads=2)
    return ref.result(), got


@pytest.mark.parametrize("name,mesh", [(n, m) for n in CONFIGS
                                       for m in MESHES_OF[n]])
def test_model_logits_match_reference_on_mesh(both, name, mesh):
    want, got = both
    keys = ["prefill", "chunk"] + [f"decode{i}" for i in range(STEPS)]
    for k in keys:
        key = f"{name}/{mesh}/{k}"
        err = rel_err(got[0][key], want[key])
        assert err < 1e-4, (key, err)
        for g in got[1:]:
            np.testing.assert_array_equal(g[key], got[0][key])


@pytest.mark.parametrize("mesh", list(ENGINES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_tokens_match_reference_on_every_rank(both, name, mesh):
    want, got = both
    ref = want[f"{name}/engine/{ENGINES[mesh]}"].tolist()
    assert all(len(t) == 6 for t in ref)
    for g in got:
        assert g[f"{name}/engine/{mesh}"] == ref


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_on_a_mesh_is_the_ranks_block_of_the_seeded_weights(both,
                                                                 name):
    _, got = both
    for g in got:
        assert g[f"{name}/init/True"] is True
        assert g[f"{name}/init/False"] is True


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world_size_one_is_the_one_device_path(both, name):
    _, got = both
    for g in got:
        assert g[f"{name}/world1"] is True
        assert g[f"{name}/world1/engine"] is True
        # the (2,2) mesh moved bytes over every kind of collective
        assert {"all_gather", "psum"} <= set(g[f"{name}/sent"])
