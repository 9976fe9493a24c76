"""The shared body of ``tests/test_torch_sharded_{recurrent,memory}.py``:
whole models and the serving engine of the families whose mixers are
RG-LRU, SSD, cross-attention and the encoder, on meshes over gloo ranks,
against the reference on the same Auto-axis meshes.

A test file names its configurations (``CONFIGS``: name → (registry
name, field overrides)) and calls :func:`run`: the port's seeded weights
(``Model.init(0)``, float32), then ONE reference subprocess
(:func:`reference_body`, on those weights) and ONE ``spawn`` of 4 gloo
ranks (:func:`rank_main`) side by side. Per configuration and mesh of
:data:`MESHES`, in float32:
``Model.prefill`` of a seeded batch (with a seeded memory where the
model reads one), the cache padded to ``L`` slots and placed in the
decode layout, then ``STEPS`` ``decode_step``s; ``FlowServeEngine(ctx=)``
on :data:`ENGINE_MESHES` (the reference's engine on (1,2): it emits the
same tokens on every mesh); in bfloat16 the port's same steps on
:data:`BF16_MESH` (the weights cast leaf by leaf), held to the
reference's float32 ones; and on a live mesh of one rank (world size 1 per
replica) the mesh code path against the one-device path; a module's
``HELD_TO_ONE_DEVICE`` configurations run on (1,2) against the port's
one-device path (itself held to the reference). The 2-rank
meshes run on the 4 ranks as replicas along a leading axis ``r`` that no
collective names.

This module imports only numpy at its top: the reference subprocess and
the spawned ranks import it by name.
"""
from __future__ import annotations

import numpy as np

B, S, L, STEPS = 4, 16, 48, 3
#: name → (reference mesh shape, shard_kv_seq)
MESHES = {"2x1": ((2, 1), True), "1x2": ((1, 2), True),
          "2x2": ((2, 2), True), "2x2/noseq": ((2, 2), False)}
ENGINE_MESHES = ("2x1", "1x2", "2x2")
BF16_MESH = "2x2"
#: the last prompt is longer than a smoke ring window (64): its prefill
#: keeps the trailing window and decode wraps around the ring
PROMPTS = ["hello world", "the quick brown fox jumps", "a",
           "a longer prompt that runs past the smoke model's ring window "
           "of sixty-four slots"]
NEW, ENGINE_LEN = 6, 128


def config(get_config, configs, name, dtype="float32"):
    import dataclasses

    arch, kw = configs[name]
    return dataclasses.replace(get_config(arch), dtype=dtype, **kw)


def inputs(cfg):
    """(tokens [B, S], decode tokens [STEPS, B, 1], memory [B, M, md] f32
    or None), seeded."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    mem = None
    if any(m == "cross_attn" for m, _ in cfg.layer_kinds()):
        md = cfg.encoder_d_model or cfg.d_model
        mem = rng.standard_normal(
            (B, cfg.num_frontend_tokens, md)).astype(np.float32)
    return toks, dec, mem


def reference_body(module: str) -> str:
    """The reference's program (after ``torch_mesh.PREAMBLE``) for the
    configurations of test module ``module``, on the weights :func:`run`
    wrote (``weights.pkl``: name → the parameter tree, numpy leaves)."""
    return f"""
import pickle
from repro.configs import get_config
from repro.models.mesh_ctx import MeshCtx
from repro.models.transformer import build_model
from repro.serving.flowserve import FlowServeEngine
from repro.serving.request import Request
from torch_mesh_serving import (ENGINE_LEN, MESHES, NEW, PROMPTS, B, L, S,
                                STEPS, config, inputs)
from {module} import CONFIGS
with open(os.path.join(DIR, "weights.pkl"), "rb") as f:
    weights = {{name: jax.tree.map(jnp.asarray, tree)
               for name, tree in pickle.load(f).items()}}


def pad(full, part):
    return jnp.pad(part, [(0, f - p) for f, p in zip(full.shape,
                                                      part.shape)])


for name in CONFIGS:
    cfg = config(get_config, CONFIGS, name)
    toks, dec, mem = inputs(cfg)
    for mname, (shape, seq) in MESHES.items():
        ctx = MeshCtx(mesh=auto_mesh(shape), batch_axes=("data",),
                      remat="none", shard_kv_seq=seq)
        m = build_model(cfg, ctx)
        lp, c = jax.jit(m.prefill)(weights[name], jnp.asarray(toks),
                                   None if mem is None else jnp.asarray(mem))
        put(f"{{name}}/{{mname}}/prefill", lp)
        cache = jax.tree.map(pad, m.init_cache(B, L), c)
        step = jax.jit(m.decode_step)
        for i in range(STEPS):
            ld, cache = step(weights[name], cache, jnp.asarray(dec[i]),
                             jnp.full((B,), S + i, jnp.int32))
            put(f"{{name}}/{{mname}}/decode{{i}}", ld)
    ctx = MeshCtx(mesh=auto_mesh((1, 2)), batch_axes=("data",),
                  remat="none")
    eng = FlowServeEngine(cfg, weights[name], ctx=ctx, n_dp_groups=2,
                          max_batch=2, max_len=ENGINE_LEN,
                          memory=None if mem is None
                          else jnp.asarray(mem[:1]))
    reqs = [Request(prompt=p, max_new_tokens=NEW, ignore_eos=True)
            for p in PROMPTS]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    eng.close()
    put(f"{{name}}/engine", np.asarray([list(r.output_tokens)
                                        for r in reqs], np.int32))
"""


def _port_mesh(shape):
    if shape[0] * shape[1] == 4:
        return shape, ("data", "model")
    return (4 // (shape[0] * shape[1]),) + shape, ("r", "data", "model")


def run_steps(m, params, cfg):
    """Prefill, the cache padded to ``L`` slots and placed, then
    ``STEPS`` decode steps → {step: logits}."""
    import torch

    toks, dec, mem = (None if a is None else torch.from_numpy(a)
                      for a in inputs(cfg))
    out = {}
    lp, c = m.prefill(params, toks.long(), memory=mem)
    out["prefill"] = lp.float().numpy()
    cache = m.init_cache(B, L, device="cpu")
    for keys, t in _leaves(cache).items():
        part = _leaves(c)[keys]
        t[tuple(slice(0, n) for n in part.shape)].copy_(part)
    cache = m.place_cache(cache, B)
    for i in range(STEPS):
        ld, cache = m.decode_step(params, cache,
                                  dec[i].long(),
                                  torch.full((B,), S + i, dtype=torch.int32))
        out[f"decode{i}"] = ld.float().numpy()
    return out


def _leaves(tree):
    from repro_torch.launch.sharding import leaves_by_path

    return leaves_by_path(tree)


def serve(cfg, params, ctx):
    """Greedy tokens of ``FlowServeEngine(ctx=)`` on :data:`PROMPTS`."""
    import torch

    from repro_torch.serving.flowserve import FlowServeEngine
    from repro_torch.serving.request import Request

    mem = inputs(cfg)[2]
    eng = FlowServeEngine(cfg, params, device="cpu", ctx=ctx,
                          n_dp_groups=2, max_batch=2, max_len=ENGINE_LEN,
                          memory=None if mem is None
                          else torch.from_numpy(mem[:1]))
    reqs = [Request(prompt=p, max_new_tokens=NEW, ignore_eos=True)
            for p in PROMPTS]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    eng.close()
    return [list(r.output_tokens) for r in reqs]


def rank_main(rank, world, init, module, flat_params):
    """One gloo rank: every configuration of ``module`` on every mesh, and
    its ``HELD_TO_ONE_DEVICE`` configurations on (1,2)."""
    import importlib

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import from_jax_params

    mod = importlib.import_module(module)
    configs = mod.CONFIGS
    out, meshes = {}, {}

    def mesh(shape):
        pshape, names = _port_mesh(shape)
        if pshape not in meshes:
            meshes[pshape] = init_mesh(pshape, "gloo", "cpu",
                                       axis_names=names, rank=rank,
                                       world_size=world, init_method=init)
        return meshes[pshape]

    for name in configs:
        cfg = config(get_config, configs, name)
        flat = flat_params[name]
        for mname, (shape, seq) in MESHES.items():
            ctx = MeshCtx(mesh=mesh(shape), batch_axes=("data",),
                          remat="none", shard_kv_seq=seq)
            m = Model(cfg, ctx=ctx)
            params = from_jax_params(flat, cfg, "cpu", ctx=ctx)
            for k, v in run_steps(m, params, cfg).items():
                out[f"{name}/{mname}/{k}"] = v
            if mname in ENGINE_MESHES:
                out[f"{name}/engine/{mname}"] = serve(cfg, params, ctx)
        shape, seq = MESHES[BF16_MESH]
        bcfg = config(get_config, configs, name, "bfloat16")
        ctx = MeshCtx(mesh=mesh(shape), batch_axes=("data",), remat="none",
                      shard_kv_seq=seq)
        params = from_jax_params(flat, bcfg, "cpu", ctx=ctx,
                                 dtype=torch.float32)
        # the bfloat16 model's weights: the float32 ones in its leaves'
        # dtypes, as the reference casts them
        params = shd.spec_tree_map(lambda t, s: t.to(s.dtype), params,
                                   Model(bcfg).param_spec())
        for k, v in run_steps(Model(bcfg, ctx=ctx), params, bcfg).items():
            out[f"{name}/bf16/{k}"] = v
        # world size 1 with a live group, the mesh code path: bit for bit
        # the one-device path
        one = MeshCtx(mesh=mesh((1, 1)), batch_axes=("data",), remat="none")
        m1 = Model(cfg, ctx=one)
        assert m1.sharded
        p1 = from_jax_params(flat, cfg, "cpu", ctx=one)
        p0 = from_jax_params(flat, cfg, "cpu")
        a, b = run_steps(m1, p1, cfg), run_steps(Model(cfg), p0, cfg)
        out[f"{name}/world1"] = all(np.array_equal(a[k], b[k]) for k in a)
        out[f"{name}/world1/engine"] = (serve(cfg, p1, one)
                                        == serve(cfg, p0, None))
        out[f"{name}/sent"] = dict(meshes[(2, 2)].comm.sent)
    # configurations held to the port's one-device path (itself held to
    # the reference) on (1,2): the seed's weights, f32
    held = getattr(mod, "HELD_TO_ONE_DEVICE", {})
    for name in held:
        cfg = config(get_config, held, name)
        ctx = MeshCtx(mesh=mesh((1, 2)), batch_axes=("data",), remat="none")
        got = run_steps(Model(cfg, ctx=ctx),
                        Model(cfg, ctx=ctx).init(0, device="cpu"), cfg)
        want = run_steps(Model(cfg), Model(cfg).init(0, device="cpu"), cfg)
        out[f"{name}/held"] = {k: float(np.abs(got[k] - want[k]).max()
                                        / np.abs(want[k]).max())
                               for k in want}
    return out


def run(tmp_path_factory, module: str, configs):
    """(reference outputs, each rank's outputs), both on the port's
    seeded float32 weights of each configuration."""
    import pickle

    from torch_mesh import Reference

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import flatten

    d = tmp_path_factory.mktemp("ref")
    trees = {name: tree_map(lambda t: t.numpy(), Model(
        config(get_config, configs, name)).init(0, device="cpu"))
        for name in configs}
    with open(d / "weights.pkl", "wb") as f:
        pickle.dump(trees, f)
    ref = Reference(d, reference_body(module), timeout=900)
    got = spawn(rank_main, 4, module,
                {name: flatten(t) for name, t in trees.items()}, threads=1)
    return ref.result(), got
