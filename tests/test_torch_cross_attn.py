"""Cross-attention, the encoder and their weights, module by module,
against the JAX reference with the same inputs (numpy, from a seed).

* ``cross_attn_apply`` in prefill (the memory projected to K/V, which
  become the layer's cache) and in decode (the cache read, never
  written; on the CPU the decode-attention kernel's plain version over
  every slot), float32 within 2e-4 and bf16 within 3e-2 of the
  reference's ``cross_attn_apply``, with a memory wider than the model
  (``encoder_d_model`` != ``d_model``) too.
* The pad-to-slot rule: a memory shorter than the slot's
  ``num_frontend_tokens`` is zero-padded by ``write_slot``, and decode
  attends the zero keys (score 0) as the reference's
  ``naive_attention(causal=False)`` does.
* ``Model.encode`` (non-causal, un-roped (ATTN, MLP) blocks and an RMS
  norm) against the reference's ``encode``.
* The weight bridge's ``encoder.*`` and cross-attention leaves: every
  leaf carried one to one, the port's own random weights of the same
  shapes and types, and a missing or unexpected leaf raises.
* The decode-attention kernel's partition (``plan``, ``block_work``) at
  the served cross-attention shapes (Llama-3.2-Vision: G 4, hd 128, L
  1601, not a power of two; SeamlessM4T: G 1, hd 64, L 512): every
  (row, head, slot) walked once, and the partition's arithmetic equal
  to the plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.kernels.decode_attention.kernel import block_work, plan
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import attention as TA
from repro_torch.models.transformer import Model
from repro_torch.models.weights import flatten, from_jax_params
from repro_torch.serving.backend import TorchBackend
from test_torch_decode_attention_split import partitioned
from torch_parity import auto_ctx, configs, memory, reference, rel_err

BAR = {"float32": 2e-4, "bfloat16": 3e-2}
B, S = 2, 6


def _cross_params(cfg, seed):
    """Numpy cross-attention weights of ``cfg``'s shapes."""
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) / np.sqrt(fan)).astype(np.float32)
            for n, (s, fan) in TA.cross_attn_param_shapes(cfg).items()}


def _both(a, dtype):
    """A numpy array as (jax array, torch tensor) of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("md", [0, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", ["vision-gqa", "seamless"])
def test_cross_attn_prefill_and_decode_match_jax(config, dtype, md):
    jcfg, tcfg = configs(dtype, config=config)
    if md:
        jcfg, tcfg = (dataclasses.replace(c, encoder_d_model=md)
                      for c in (jcfg, tcfg))
    params = _cross_params(tcfg, 7)
    jp = {n: _both(a, dtype)[0] for n, a in params.items()}
    tp = {n: _both(a, dtype)[1] for n, a in params.items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    mem = memory(tcfg, B, seed=9)
    assert mem.shape[-1] == (md or tcfg.d_model)
    (jx, tx), (jm, tm) = _both(x, dtype), _both(mem, dtype)
    ctx = auto_ctx()
    jy, jc = JA.cross_attn_apply(jp, jx, cfg=jcfg, ctx=ctx, mode="prefill",
                                 memory=jm)
    ty, tc = TA.cross_attn_apply(tp, tx, cfg=tcfg, mode="prefill",
                                 memory=tm)
    assert rel_err(ty, jy) <= BAR[dtype]
    for n in ("k", "v"):
        assert tc[n].shape == (B, tcfg.num_frontend_tokens,
                               tcfg.num_kv_heads, tcfg.resolved_head_dim)
        assert rel_err(tc[n], jc[n]) <= BAR[dtype], n
    # decode: one token over the cache, which stays as it was
    jx1, tx1 = _both(x[:, :1], dtype)
    before = {n: t.clone() for n, t in tc.items()}
    jy1, _ = JA.cross_attn_apply(jp, jx1, cfg=jcfg, ctx=ctx, mode="decode",
                                 cache=jc)
    ty1, tc1 = TA.cross_attn_apply(tp, tx1, cfg=tcfg, mode="decode",
                                   cache=tc)
    assert tc1 is tc and all(torch.equal(tc[n], before[n]) for n in tc)
    assert rel_err(ty1, jy1) <= BAR[dtype]


def test_cross_attn_needs_memory_and_refuses_chunks():
    _, tcfg = configs("float32", config="vision")
    tp = {n: torch.from_numpy(a)
          for n, a in _cross_params(tcfg, 1).items()}
    x = torch.zeros((1, 2, tcfg.d_model))
    with pytest.raises(ValueError, match="memory"):
        TA.cross_attn_apply(tp, x, cfg=tcfg, mode="prefill")
    with pytest.raises(ValueError, match="unsupported mode"):
        TA.cross_attn_apply(tp, x, cfg=tcfg, mode="chunk", cache={})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", ["vision-gqa", "seamless"])
def test_short_memory_pads_are_attended_as_the_reference(config, dtype):
    """A 5-slot memory into a 16-slot cross cache: ``write_slot`` zero-
    pads it, and a decode step attends the 11 zero keys too, as the
    reference does on the same padded cache."""
    jcfg, jmodel, jparams, tcfg, tparams = reference(dtype, config=config)
    M, P = 5, 7
    assert M < tcfg.num_frontend_tokens
    mem = memory(tcfg, 1, M, seed=3)
    toks = np.random.default_rng(5).integers(
        3, tcfg.vocab_size, (1, P)).astype(np.int32)
    model = Model(tcfg)
    be = TorchBackend(model, tparams, max_len=32, device="cpu")
    with torch.no_grad():
        _, c1 = model.prefill(tparams, torch.from_numpy(toks),
                              memory=torch.from_numpy(mem))
    cross = "blocks.pos4" if config.startswith("vision") else "blocks.pos1"
    assert flatten(c1)[cross + ".k"].shape[2] == M
    cache = be.write_slot(model.init_cache(1, 32, device="cpu"), c1, 0)
    k = flatten(cache)[cross + ".k"]
    assert k.shape[2] == tcfg.num_frontend_tokens
    assert not k[:, 0, M:].any() and k[:, 0, :M].abs().sum() > 0

    jm = jnp.asarray(mem, jmodel.dtype)
    _, jc1 = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks), jm)
    jc = jax.tree.map(lambda c, s: jnp.pad(
        c, [(0, st - ct) for ct, st in zip(c.shape, s.shape)]), jc1,
        jmodel.cache_spec(1, 32))
    tok = np.asarray([[toks[0, -1]]], np.int32)
    pos = np.asarray([P], np.int32)
    jl, _ = jax.jit(jmodel.decode_step)(jparams, jc, jnp.asarray(tok),
                                        jnp.asarray(pos))
    with torch.no_grad():
        tl, _ = model.decode_step(tparams, cache, torch.from_numpy(tok),
                                  torch.from_numpy(pos))
    assert rel_err(tl, jl) <= (1e-4 if dtype == "float32" else 0.08)

    # the pads change the output: against a 5-slot cross cache, a
    # difference above the 0.08 bf16 parity bar
    short = model.init_cache(1, 32, mem_len=M, device="cpu")
    be.write_slot(short, c1, 0)
    with torch.no_grad():
        sl, _ = model.decode_step(tparams, short, torch.from_numpy(tok),
                                  torch.from_numpy(pos))
    assert rel_err(sl, tl) > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(dtype):
    jcfg, jmodel, jparams, tcfg, tparams = reference(dtype,
                                                     config="seamless")
    frames = memory(tcfg, B, 12, seed=11)
    want = jax.jit(jmodel.encode)(jparams,
                                  jnp.asarray(frames, jmodel.dtype))
    with torch.no_grad():
        got = Model(tcfg).encode(tparams, torch.from_numpy(frames))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, 12, tcfg.encoder_d_model)
    assert rel_err(got, want) <= BAR[dtype]


@pytest.mark.parametrize("config", ["vision", "seamless"])
def test_bridge_carries_encoder_and_cross_leaves(config):
    _, _, jparams, tcfg, _ = reference("bfloat16", config=config)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    got = flatten(from_jax_params(tree, tcfg, "cpu"))
    want = flatten(tree)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(np.asarray(got[p].float()),
                              np.asarray(want[p], np.float32))
               for p in want)
    enc = sorted(p for p in got if p.startswith("encoder."))
    if config == "seamless":
        assert "encoder.norm" in enc
        assert {p.split(".")[2] for p in enc
                if p.startswith("encoder.blocks.")} == {"0", "1"}
        assert got["encoder.blocks.0.mixer.wq"].shape == (
            tcfg.encoder_d_model, tcfg.num_heads, tcfg.resolved_head_dim)
        cross = "blocks.pos1.mixer"
    else:
        assert not enc
        cross = "blocks.pos4.mixer"
    assert got[cross + ".wk"].shape == (
        1, tcfg.encoder_d_model or tcfg.d_model, tcfg.num_kv_heads,
        tcfg.resolved_head_dim)
    spec = {p: (tuple(t.shape), t.dtype) for p, t in flatten(
        Model(tcfg).init(0, device="cpu")).items()}
    assert spec == {p: (tuple(t.shape), t.dtype) for p, t in got.items()}
    # the encoder's norm missing, or an encoder where the model has none
    if enc:
        bad, what = {**tree, "encoder": {
            "blocks": tree["encoder"]["blocks"]}}, "missing"
    else:
        bad, what = {**tree, "encoder": {
            "norm": np.zeros(tcfg.d_model, np.float32)}}, "unexpected"
    with pytest.raises(KeyError, match=f"{what} \\['encoder.norm'\\]"):
        from_jax_params(bad, tcfg, "cpu")


#: the served cross-attention decode shapes: B, H, KV, hd, L
CROSS = {"llama-3.2-vision-11b": (4, 32, 8, 128, 1601),
         "seamless-m4t-medium": (4, 16, 16, 64, 512)}


@pytest.mark.parametrize("n_sms", [132, 4])
@pytest.mark.parametrize("model", list(CROSS))
def test_cross_shape_partition_covers_every_slot_once(model, n_sms):
    B, H, KV, hd, L = CROSS[model]
    p = plan(B, H, KV, hd, L, n_sms)
    assert p["n_grp"] == 1 and p["gpb"] == H // KV
    positions = [L - 1] * B
    walked = np.zeros((B, H, L), np.int64)
    for split in range(p["n_split"]):
        for y in range(KV * p["n_grp"]):
            for b in range(B):
                heads, slots = block_work(p, H, KV, L, positions, 0,
                                          split, y, b)
                walked[b, heads.start:heads.stop,
                       slots.start:slots.stop] += 1
    assert np.array_equal(walked, np.ones((B, H, L), np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", list(CROSS))
def test_cross_shape_partition_matches_plain_version(model, dtype):
    """The kernel's split-and-merge arithmetic at the cross shape, with
    the zero pads of a short memory among the slots, equals the plain
    version's."""
    _, H, KV, hd, L = CROSS[model]
    rng = np.random.default_rng(L)
    q, k, v = (rng.standard_normal(s).astype(np.float32) * 0.5 for s in
               ((2, H, hd), (2, L, KV, hd), (2, L, KV, hd)))
    k[1, L // 3:], v[1, L // 3:] = 0.0, 0.0       # a padded short memory
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    tpos = torch.full((2,), L - 1, dtype=torch.int32)
    want = decode_attention_ref(tq, tk, tv, tpos)
    for n_sms in (132, 4):
        got = partitioned(tq, tk, tv, tpos, n_sms=n_sms)
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=BAR[dtype], atol=BAR[dtype])
