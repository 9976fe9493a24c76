"""The shared body of ``tests/test_torch_sharded_train{,_mixers}.py``:
training on meshes over gloo ranks, against the reference's
``jax.value_and_grad(forward_train)`` on the same Auto-axis meshes.

A test file names its configurations (``CONFIGS``: name → (registry
name, field overrides)), the meshes each runs on (``MESHES_OF``) and
calls :func:`run`: the port's seeded float32 weights (``Model.init(0)``),
then ONE reference subprocess (:func:`reference_body`, on those weights)
and ONE ``spawn`` of :data:`WORLD` gloo ranks (or the module's
``WORLD``; :func:`rank_main`) side by side. Per configuration and mesh:
the loss, every metric and every leaf's gradient (each rank's blocks gathered to the global leaf), and
one AdamW update (``grad_norm``, ``lr`` and the moments). Smaller meshes
run as replicas along a leading axis ``r`` that no collective names (the
first replica computes a case, the others skip it). A
file may add configurations that run on no mesh here
(``EXTRA_CONFIGS``: their weights are written too) and extra work on
both sides (``run(extra_reference=)``, the module's ``extra_rank``).

This module imports only numpy at its top: the reference subprocess and
the spawned ranks import it by name.
"""
from __future__ import annotations

import math

import numpy as np

B, S = 4, 32
#: the ranks of the port's world unless the module sets ``WORLD`` (the
#: largest mesh, (4,2), is 8 ranks)
WORLD = 8
#: name → reference mesh shape
MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2), "4x2": (4, 2)}
METRICS = ("loss", "nll", "moe_lb_loss", "moe_z_loss", "tokens",
           "expert_counts")


def config(get_config, configs, name, dtype="float32"):
    import dataclasses

    arch, kw = configs[name]
    return dataclasses.replace(get_config(arch), dtype=dtype, **kw)


def inputs(cfg):
    """(tokens, labels [B, S] int32, memory [B, M, md] f32 or None)."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mem = None
    if any(m == "cross_attn" for m, _ in cfg.layer_kinds()):
        md = cfg.encoder_d_model or cfg.d_model
        mem = rng.standard_normal(
            (B, cfg.num_frontend_tokens, md)).astype(np.float32)
    return toks, labels, mem


def path_name(keys) -> str:
    """A dotted leaf path from jax key entries or port keys."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


def reference_body(module: str) -> str:
    """The reference's program (after ``torch_mesh.PREAMBLE``) for the
    configurations of test module ``module``, on the weights :func:`run`
    wrote (``weights.pkl``)."""
    return f"""
import pickle
from repro.configs import get_config
from repro.models.mesh_ctx import MeshCtx
from repro.models.transformer import build_model
from repro.train.optimizer import AdamWConfig, adamw_update, init_adamw
from torch_mesh_train import MESHES, METRICS, config, inputs, path_name
import {module} as mod
with open(os.path.join(DIR, "weights.pkl"), "rb") as f:
    weights = {{name: jax.tree.map(jnp.asarray, tree)
               for name, tree in pickle.load(f).items()}}


def ctx_of(shape, **kw):
    kw.setdefault("remat", "none")
    return MeshCtx(mesh=auto_mesh(shape), batch_axes=("data",), **kw)


def tree_put(prefix, tree):
    for n, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        put(prefix + path_name(n), a)


for name in mod.CONFIGS:
    cfg = config(get_config, mod.CONFIGS, name)
    toks, labels, mem = (None if a is None else jnp.asarray(a)
                         for a in inputs(cfg))
    params = weights[name]
    update = jax.jit(lambda p, g: adamw_update(AdamWConfig(), p, g,
                                               init_adamw(p)))
    for mname in mod.MESHES_OF[name]:
        m = build_model(cfg, ctx_of(MESHES[mname]))
        f = jax.jit(jax.value_and_grad(
            lambda p: m.forward_train(p, toks, labels, memory=mem),
            has_aux=True))
        (loss, met), g = f(params)
        key = f"{{name}}/{{mname}}/"
        put(key + "loss", loss)
        for k in METRICS[1:]:
            put(key + k, met[k])
        tree_put(key + "grad/", g)
        _, st, om = update(params, g)
        put(key + "grad_norm", om["grad_norm"])
        put(key + "lr", om["lr"])
        tree_put(key + "m/", st.m)
        tree_put(key + "v/", st.v)
"""


def _port_mesh(shape, world):
    n = shape[0] * shape[1]
    if n == world:
        return shape, ("data", "model")
    return (world // n,) + shape, ("r", "data", "model")


def global_tree(m, tree):
    """``tree`` (this rank's blocks under ``m.specs``) gathered to the
    global leaves, as {dotted path: numpy}."""
    import torch

    from repro_torch.launch import sharding as shd

    flat = shd.leaves_by_path(m.specs)
    with torch.no_grad():
        return {path_name(k): shd.gather_local(t, flat[k], m.ctx).numpy()
                for k, t in shd.leaves_by_path(tree).items()}


def train_case(m, params, cfg):
    """The loss, metrics, global gradient and one AdamW update of ``m``
    (on this rank's ``params``) → {name: value}."""
    import torch

    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_adamw)
    from repro_torch.train.train_loop import loss_and_grads

    toks, labels, mem = (None if a is None else torch.from_numpy(a)
                         for a in inputs(cfg))
    out = {}
    comm = m.ctx.comm
    comm.sent.clear()
    (loss, met), g = loss_and_grads(m, params, toks.long(), labels.long(),
                                    memory=mem)
    out["sent"] = dict(comm.sent)
    out["loss"] = float(loss)
    for k in ("nll", "moe_lb_loss", "moe_z_loss", "tokens",
              "expert_counts"):
        out[k] = met[k].numpy()
    out.update({"grad/" + k: v for k, v in global_tree(m, g).items()})
    _, st, om = adamw_update(AdamWConfig(), params, g, init_adamw(params),
                             m.ctx, m.specs)
    out["grad_norm"] = float(om["grad_norm"])
    out["lr"] = float(om["lr"])
    out.update({"m/" + k: v for k, v in global_tree(m, st.m).items()})
    out.update({"v/" + k: v for k, v in global_tree(m, st.v).items()})
    return out


def rank_main(rank, world, init, module, flat_params):
    """One gloo rank: every configuration of ``module`` on its meshes,
    then the module's ``extra_rank``."""
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import from_jax_params

    mod = importlib.import_module(module)
    out, meshes = {}, {}

    def mesh(shape):
        pshape, names = _port_mesh(shape, world)
        if pshape not in meshes:
            meshes[pshape] = init_mesh(pshape, "gloo", "cpu",
                                       axis_names=names, rank=rank,
                                       world_size=world, init_method=init)
            # every group a case uses, made by every rank now: a replica
            # that skips a case then makes none alone
            for axes in (("data",), ("model",), ("data", "model")):
                meshes[pshape].comm.group(axes)
        return meshes[pshape]

    def ctx_of(shape, **kw):
        kw.setdefault("remat", "none")
        return MeshCtx(mesh=mesh(shape), batch_axes=("data",), **kw)

    for name in mod.CONFIGS:
        cfg = config(get_config, mod.CONFIGS, name)
        for mname in mod.MESHES_OF[name]:
            ctx = ctx_of(MESHES[mname])
            if rank >= MESHES[mname][0] * MESHES[mname][1]:
                continue          # another replica: replica 0 computes it
            params = from_jax_params(flat_params[name], cfg, "cpu", ctx=ctx)
            for k, v in train_case(Model(cfg, ctx=ctx), params,
                                   cfg).items():
                out[f"{name}/{mname}/{k}"] = v
    extra = getattr(mod, "extra_rank", None)
    if extra is not None:
        out.update(extra(rank, ctx_of, flat_params))
    return out


def run(tmp_path_factory, module: str, extra_reference: str = ""):
    """(reference outputs, each rank's outputs), both on the port's
    seeded float32 weights of each configuration of ``module``."""
    import importlib
    import pickle

    from torch_mesh import Reference

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import flatten

    mod = importlib.import_module(module)
    d = tmp_path_factory.mktemp("ref")
    every = dict(mod.CONFIGS, **getattr(mod, "EXTRA_CONFIGS", {}))
    trees = {name: tree_map(lambda t: t.numpy(), Model(
        config(get_config, every, name)).init(0, device="cpu"))
        for name in every}
    with open(d / "weights.pkl", "wb") as f:
        pickle.dump(trees, f)
    ref = Reference(d, reference_body(module) + extra_reference,
                    timeout=1200)
    got = spawn(rank_main, getattr(mod, "WORLD", WORLD), module,
                {name: flatten(t) for name, t in trees.items()}, threads=1)
    return ref.result(), got


def check_case(want, got, key, bar=1e-4):
    """Every value of case ``key`` (config/mesh) within ``bar`` relative
    of the reference's, and the same loss on every rank. → the worst
    gradient error."""
    from torch_mesh import rel_err

    g0 = got[0]
    for k in METRICS:
        assert rel_err(g0[f"{key}/{k}"], want[f"{key}/{k}"]) < bar, (key, k)
    for k in ("grad_norm", "lr"):
        assert rel_err(g0[f"{key}/{k}"], want[f"{key}/{k}"]) < bar, (key, k)
    worst = 0.0
    leaves = [k for k in want if k.startswith(key + "/grad/")]
    assert leaves
    for k in leaves:
        b = want[k]
        if np.max(np.abs(b)) == 0:
            np.testing.assert_array_equal(g0[k], b, err_msg=k)
            continue
        err = rel_err(g0[k], b)
        worst = max(worst, err)
        assert err < bar, (k, err)
        for part in ("m/", "v/"):
            mk = k.replace("/grad/", "/" + part)
            assert rel_err(g0[mk], want[mk]) < 2 * bar, mk
    ranks = [g for g in got if f"{key}/loss" in g]
    assert len(ranks) == math.prod(MESHES[key.split("/")[1]])
    for g in ranks[1:]:
        assert g[f"{key}/loss"] == g0[f"{key}/loss"]
        assert g[f"{key}/grad_norm"] == g0[f"{key}/grad_norm"]
    return worst
