"""Attention on meshes over gloo ranks, against the reference on the same
mesh, within 2e-4 in f32:

* ``decode_attention_distributed``: flash-decoding over a cache whose
  slots are sharded over the model axis, global and ring window, on
  (1,4) and (1,8) — the output and the cache after the owner rank's
  write of the new token (the decode-attention kernel's partial output,
  its plain version here, combined by ``pmax`` / ``psum``);
* ``_mla_decode_distributed`` on (1,4);
* tensor-parallel heads: the Llama-4 smoke model with 10 query heads on
  2 KV heads (``tests/torch_parity.py``'s ``llama4-gqa``) on TP 4, its
  heads padded to 12 with K/V repeated per query head, and 8 heads on 2
  KV heads (each rank's heads on a KV head it does not own); prefill,
  a chunk, and decode.

The (1,4) meshes run on the 8 ranks of one world as two replicas along a
leading axis ``r`` that no collective names.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_mesh import reference

B, H, KV, HD, L = 2, 8, 4, 32, 64
POS = {"global": [40, 63], "ring": [70, 200]}
MLA = dict(H=4, R=32, ROPE=16, SCALE=48)
GQA = {"gqa10": {"num_heads": 10, "num_kv_heads": 2, "head_dim": 32},
       "gqa8": {"num_heads": 8, "num_kv_heads": 2, "head_dim": 32}}
S_PRE, L_DEC = 8, 16


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"q": f(B, 1, H, HD), "kn": f(B, 1, KV, HD), "vn": f(B, 1, KV, HD),
            "ck": f(1, B, L, KV, HD), "cv": f(1, B, L, KV, HD),
            "ql": f(B, 1, MLA["H"], MLA["R"]),
            "qr": f(B, 1, MLA["H"], MLA["ROPE"]),
            "ckvn": f(B, 1, MLA["R"]), "kropen": f(B, 1, MLA["ROPE"]),
            "ckv": f(1, B, L, MLA["R"]), "krope": f(1, B, L, MLA["ROPE"])}


def gqa_config(get_config, name):
    import dataclasses

    return dataclasses.replace(get_config("llama4-maverick-400b-a17b-smoke"),
                               dtype="float32", **GQA[name])


REFERENCE = """
from repro.configs import get_config
from repro.models.attention import (_mla_decode_distributed, attn_apply,
                                    attn_init, decode_attention_distributed)
from repro.models.cache_ref import CacheRef
from repro.models.mesh_ctx import MeshCtx
from test_torch_sharded_attention import (GQA, L_DEC, POS, S_PRE, MLA,
                                          _inputs, gqa_config)
a = {k: jnp.asarray(v) for k, v in _inputs().items()}
for shape in ((1, 4), (1, 8)):
    ctx = MeshCtx(mesh=auto_mesh(shape), batch_axes=("data",), remat="none")
    for kind, pos in POS.items():
        w = a["ck"].shape[2] if kind == "ring" else 0
        f = jax.jit(lambda q, kn, vn, ck, cv, p: decode_attention_distributed(
            q, kn, vn, CacheRef({"k": ck, "v": cv}, 0), p, ctx, window=w))
        out, ref = f(a["q"], a["kn"], a["vn"], a["ck"], a["cv"],
                     jnp.asarray(pos, jnp.int32))
        put(f"da/{shape}/{kind}/out", out)
        put(f"da/{shape}/{kind}/k", ref.stack["k"])
        put(f"da/{shape}/{kind}/v", ref.stack["v"])
ctx4 = MeshCtx(mesh=auto_mesh((1, 4)), batch_axes=("data",), remat="none")
pos = jnp.asarray(POS["global"], jnp.int32)
f = jax.jit(lambda *x: _mla_decode_distributed(
    *x[:4], CacheRef({"ckv": x[4], "krope": x[5]}, 0), x[6], ctx4,
    MLA["SCALE"]))
out, ref = f(a["ql"], a["qr"], a["ckvn"], a["kropen"], a["ckv"],
             a["krope"], pos)
put("mla/out", out)
put("mla/ckv", ref.stack["ckv"])
put("mla/krope", ref.stack["krope"])
rng = np.random.default_rng(3)
for name in GQA:
    cfg = gqa_config(get_config, name)
    params = attn_init(jax.random.PRNGKey(1), cfg, jnp.float32)
    for n, v in params.items():
        put(f"{name}/param/{n}", v)
    x = jnp.asarray(rng.standard_normal((2, S_PRE, cfg.d_model)),
                    jnp.float32)
    x1 = jnp.asarray(rng.standard_normal((2, 1, cfg.d_model)), jnp.float32)
    put(f"{name}/x", x)
    put(f"{name}/x1", x1)
    y, c = jax.jit(lambda p, x: attn_apply(p, x, cfg=cfg, ctx=ctx4,
                                           mode="prefill"))(params, x)
    put(f"{name}/prefill/y", y)
    put(f"{name}/prefill/k", c["k"])
    buf = {n: jnp.zeros((1, 2, L_DEC) + c[n].shape[2:]).at[
        0, :, :S_PRE].set(c[n]) for n in ("k", "v")}
    y, ref = jax.jit(lambda p, x, b: attn_apply(
        p, x, cfg=cfg, ctx=ctx4, mode="chunk", cache=CacheRef(b, 0),
        positions=0))(params, x, {n: jnp.zeros_like(v) for n, v in
                                  buf.items()})
    put(f"{name}/chunk/y", y)
    put(f"{name}/chunk/k", ref.stack["k"])
    y, ref = jax.jit(lambda p, x, b, q: attn_apply(
        p, x, cfg=cfg, ctx=ctx4, mode="decode", cache=CacheRef(b, 0),
        positions=q))(params, x1, buf, jnp.asarray([S_PRE, S_PRE + 3],
                                                   jnp.int32))
    put(f"{name}/decode/y", y)
    put(f"{name}/decode/k", ref.stack["k"])
"""


def _rank(rank, world, init, a, want):
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import attention as A
    from repro_torch.models.mesh_ctx import MeshCtx

    t = {k: torch.from_numpy(v) for k, v in a.items()}
    meshes = {(1, 8): init_mesh((1, 8), "gloo", "cpu", rank=rank,
                                world_size=world, init_method=init),
              (1, 4): init_mesh((2, 1, 4), "gloo", "cpu",
                                axis_names=("r", "data", "model"),
                                rank=rank, world_size=world,
                                init_method=init)}
    ctxs = {s: MeshCtx(mesh=m, batch_axes=("data",), remat="none")
            for s, m in meshes.items()}
    out = {}

    def seq_block(x, ctx):           # this rank's slots of [B, L, ...]
        return ctx.take_block(x, 1, "model").clone()

    def gathered(x, ctx):
        return ctx.all_gather(x, "model", dim=1).numpy()
    for shape, ctx in ctxs.items():
        for kind, pos in POS.items():
            w = L if kind == "ring" else 0
            cache = {"k": seq_block(t["ck"][0], ctx),
                     "v": seq_block(t["cv"][0], ctx)}
            o = A.decode_attention_distributed(
                t["q"], t["kn"], t["vn"], cache,
                torch.tensor(pos, dtype=torch.int32), ctx, window=w)
            out[f"da/{shape}/{kind}/out"] = o.numpy()
            out[f"da/{shape}/{kind}/k"] = gathered(cache["k"], ctx)
            out[f"da/{shape}/{kind}/v"] = gathered(cache["v"], ctx)
    ctx4 = ctxs[(1, 4)]
    cache = {"ckv": seq_block(t["ckv"][0], ctx4),
             "krope": seq_block(t["krope"][0], ctx4)}
    o = A._mla_decode_distributed(
        t["ql"], t["qr"], t["ckvn"], t["kropen"], cache,
        torch.tensor(POS["global"], dtype=torch.int32), ctx4, MLA["SCALE"])
    out["mla/out"] = o.numpy()
    out["mla/ckv"] = gathered(cache["ckv"], ctx4)
    out["mla/krope"] = gathered(cache["krope"], ctx4)
    for name in GQA:
        cfg = gqa_config(get_config, name)
        full = {n: torch.from_numpy(want[f"{name}/param/{n}"])
                for n in ("wq", "wk", "wv", "wo")}
        specs = {n: shd._resolve(p.shape, shd.PARAM_RULES[(n, p.dim())],
                                 ctx4.mesh) for n, p in full.items()}
        params = {n: shd.take_local(p, specs[n], ctx4)
                  for n, p in full.items()}
        x = torch.from_numpy(want[f"{name}/x"])
        x1 = torch.from_numpy(want[f"{name}/x1"])
        y, c = A.attn_apply(params, x, cfg=cfg, mode="prefill", ctx=ctx4,
                            specs=specs)
        out[f"{name}/prefill/y"] = y.numpy()
        out[f"{name}/prefill/k"] = c["k"].numpy()
        buf = {n: torch.zeros((2, L_DEC) + tuple(c[n].shape[2:]))
               for n in ("k", "v")}
        y, cb = A.attn_apply(params, x, cfg=cfg, mode="chunk", cache=buf,
                             positions=0, ctx=ctx4, specs=specs)
        out[f"{name}/chunk/y"] = y.numpy()
        out[f"{name}/chunk/k"] = cb["k"].numpy()
        dec = {n: seq_block(cb[n], ctx4) for n in ("k", "v")}
        y, dec = A.attn_apply(params, x1, cfg=cfg, mode="decode", cache=dec,
                              positions=torch.tensor([S_PRE, S_PRE + 3],
                                                     dtype=torch.int32),
                              ctx=ctx4, specs=specs)
        out[f"{name}/decode/y"] = y.numpy()
        out[f"{name}/decode/k"] = gathered(dec["k"], ctx4)
        out[f"{name}/specs"] = {n: tuple(s) for n, s in specs.items()}
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    want = reference(tmp_path_factory.mktemp("ref"), REFERENCE)
    return want, spawn(_rank, 8, _inputs(), want)


def _check(both, keys, tol=2e-4):
    want, got = both
    for g in got:
        for k in keys:
            # the reference's stacks and [B, 1, H, hd] outputs carry a
            # unit dim the port's leaves do not
            assert want[k].size == g[k].size, k
            w = want[k].reshape(g[k].shape)
            np.testing.assert_allclose(g[k], w, rtol=tol, atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("shape", ["(1, 4)", "(1, 8)"])
@pytest.mark.parametrize("kind", list(POS))
def test_decode_attention_distributed(both, shape, kind):
    _check(both, [f"da/{shape}/{kind}/{n}" for n in ("out", "k", "v")])


def test_mla_decode_distributed(both):
    _check(both, ["mla/out", "mla/ckv", "mla/krope"])


@pytest.mark.parametrize("mode", ["prefill", "chunk", "decode"])
@pytest.mark.parametrize("name", list(GQA))
def test_tp_heads(both, name, mode):
    _check(both, [f"{name}/{mode}/y", f"{name}/{mode}/k"])
    specs = both[1][0][f"{name}/specs"]
    # 10 heads do not divide 4 (replicated, padded to 12 in compute);
    # 8 do, while 2 KV heads do not
    assert specs["wq"] == ((None, "model") if name == "gqa8" else ())
    assert specs["wk"] == ()
