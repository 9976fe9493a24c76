"""Ring-window (``LOCAL_ATTN``) GQA attention, blockwise prefill
attention and long-context serving in the port, against the JAX
reference.

* ``attn_apply`` with a window, on the smoke RecurrentGemma's local
  layer (window 64) with the reference's weights: prefill with S at
  most the window and past it, whose cache keeps the trailing window in
  ring slots ``p % window``; then decode steps across the wrap. Outputs
  within 1e-5 relative (f32). The ring caches: ``v`` bit-identical to
  the reference's; ``k`` passes through RoPE, whose cos/sin differ by an
  ulp between the frameworks, so it is held bit for bit to the
  reference's ring layout applied to the port's own full-length ``k``,
  and within 1e-6 of the reference's.
* ``decode_attention_ref`` at RecurrentGemma's decode shape (hd 256,
  10 query heads on one KV head, a ring of 2048) against the reference's
  ``_local_partial_attention`` followed by its divide.
* ``blockwise_attention`` above 2048 tokens (narrow heads) against the
  reference's, with and without a window, and ``attn_apply`` prefill
  there (which takes it).
* ``Model(long_context=True)`` on the smoke InternLM2 (global attention
  given a 256-token window): prefill past the window and greedy decode
  equal the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models.cache_ref import CacheRef
from repro.models.common import blockwise_attention as jax_blockwise
from repro.models.transformer import build_model as jax_build_model
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      valid_slots)
from repro_torch.models import attention as TA
from repro_torch.models.common import blockwise_attention
from repro_torch.configs.base import LOCAL_ATTN
from repro_torch.models.transformer import Model, attn_window
from repro_torch.models.weights import from_jax_params
from torch_parity import auto_ctx, configs, reference, rel_err, to_np

WINDOW = 64


@pytest.fixture(scope="module")
def local_layer():
    """(jax cfg, port cfg, jax params, port params) of the smoke
    RecurrentGemma's local-attention layer (superblock 0, position 2)."""
    jcfg, _, jp, tcfg, tp = reference("float32", config="recurrentgemma")
    assert attn_window(tcfg, LOCAL_ATTN) == WINDOW
    jpar = jax.tree.map(lambda a: a[0], jp["blocks"]["pos2"]["mixer"])
    tpar = {k: v[0] for k, v in tp["blocks"]["pos2"]["mixer"].items()}
    return jcfg, tcfg, jpar, tpar


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ring_like_reference(t, S):
    """The reference's ring layout (``attention.py:148-153``) of a full
    [B, S, ...] cache, computed by JAX."""
    idx = (jnp.arange(WINDOW) + (S - WINDOW)) % WINDOW
    sl = jnp.asarray(t[:, S - WINDOW:].numpy())
    return np.asarray(jnp.zeros_like(sl).at[:, idx].set(sl))


@pytest.mark.parametrize("S", [48, WINDOW, 100, 150])
def test_prefill_ring_cache_matches_reference(local_layer, S):
    jcfg, tcfg, jpar, tpar = local_layer
    x = _x((2, S, tcfg.d_model), S)
    jy, jc = JA.attn_apply(jpar, jnp.asarray(x), cfg=jcfg, ctx=auto_ctx(),
                           mode="prefill", window=WINDOW)
    with torch.no_grad():
        ty, tc = TA.attn_apply(tpar, torch.from_numpy(x), cfg=tcfg,
                               mode="prefill", window=WINDOW)
        _, full = TA.attn_apply(tpar, torch.from_numpy(x), cfg=tcfg,
                                mode="prefill")
    assert rel_err(ty, jy) <= 1e-5
    assert tuple(tc["k"].shape) == jc["k"].shape == (
        2, min(S, WINDOW), tcfg.num_kv_heads, tcfg.resolved_head_dim)
    assert np.array_equal(to_np(tc["v"]), to_np(jc["v"]))
    want_k = (_ring_like_reference(full["k"], S) if S > WINDOW
              else full["k"].numpy())
    assert np.array_equal(tc["k"].numpy(), want_k)
    assert np.abs(to_np(tc["k"]) - to_np(jc["k"])).max() <= 1e-6


def test_decode_across_the_wrap_matches_reference(local_layer):
    jcfg, tcfg, jpar, tpar = local_layer
    B, P, MAX = 2, 60, 128            # the ring holds min(MAX, WINDOW)
    x = _x((B, P, tcfg.d_model), 7)
    _, jc = JA.attn_apply(jpar, jnp.asarray(x), cfg=jcfg, ctx=auto_ctx(),
                          mode="prefill", window=WINDOW)
    with torch.no_grad():
        _, tc = TA.attn_apply(tpar, torch.from_numpy(x), cfg=tcfg,
                              mode="prefill", window=WINDOW)
    spec = TA.attn_cache_spec(tcfg, B, MAX, WINDOW)
    assert spec["k"][1] == WINDOW
    cache = {n: torch.zeros(s) for n, s in spec.items()}
    for n in cache:
        cache[n][:, :P] = tc[n]
    # the reference's decode writes a layer of a stacked cache
    stack = {n: jnp.pad(jc[n], ((0, 0), (0, WINDOW - P), (0, 0), (0, 0)))[
        None] for n in jc}
    jdec = jax.jit(lambda p, x, s, pos: JA.attn_apply(
        p, x, cfg=jcfg, ctx=auto_ctx(), mode="decode", window=WINDOW,
        cache=CacheRef(s, 0), positions=pos))
    for step in range(12):            # positions 60 .. 71: slots wrap at 64
        pos = np.full((B,), P + step, np.int32)
        pos[1] += 3
        xs = _x((B, 1, tcfg.d_model), 50 + step)
        jy, nref = jdec(jpar, jnp.asarray(xs), stack, jnp.asarray(pos))
        stack = nref.stack
        with torch.no_grad():
            ty, cache = TA.attn_apply(tpar, torch.from_numpy(xs), cfg=tcfg,
                                      mode="decode", window=WINDOW,
                                      cache=cache,
                                      positions=torch.from_numpy(pos))
        assert rel_err(ty, jy) <= 1e-5, step
    for n in cache:
        assert rel_err(cache[n], stack[n][0]) <= 1e-6, n


def test_chunk_mode_refuses_a_window(local_layer):
    _, tcfg, _, tpar = local_layer
    cache = {n: torch.zeros(s) for n, s in
             TA.attn_cache_spec(tcfg, 1, 32).items()}
    with pytest.raises(ValueError, match="global attention"):
        TA.attn_apply(tpar, torch.zeros((1, 4, tcfg.d_model)), cfg=tcfg,
                      mode="chunk", window=WINDOW, cache=cache, positions=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("positions", [[0, 2047, 2048, 3000],
                                       [4095, 5, 100, 1500]])
def test_plain_decode_attention_at_the_ring_shape(positions, dtype):
    """hd 256, G 10, KV 1, L = window 2048, rows before, at and past
    their first wrap."""
    B, H, KV, hd, L = 4, 10, 1, 256, 2048
    rng = np.random.default_rng(positions[0])
    q, k, v = (rng.standard_normal(s).astype(np.float32) * 0.5 for s in
               ((B, H, hd), (B, L, KV, hd), (B, L, KV, hd)))
    pos = np.asarray(positions, np.int32)
    jd = jnp.dtype(dtype)
    # the reference's ring rule (attention.py:286-292)
    slots = jnp.arange(L)
    delta = (jnp.asarray(pos)[:, None] - slots[None]) % L
    kv_pos = jnp.asarray(pos)[:, None] - delta
    valid = (kv_pos >= 0) & (kv_pos >= jnp.asarray(pos)[:, None] - L + 1)
    acc, l, _ = JA._local_partial_attention(
        jnp.asarray(q)[:, None].astype(jd), jnp.asarray(k).astype(jd),
        jnp.asarray(v).astype(jd), valid)
    want = np.asarray(acc / jnp.maximum(l[..., None], 1e-30))[:, 0]
    td = getattr(torch, dtype)
    tpos = torch.from_numpy(pos)
    assert np.array_equal(valid_slots(tpos, L, L).numpy(), np.asarray(valid))
    got = decode_attention_ref(torch.from_numpy(q).to(td),
                               torch.from_numpy(k).to(td),
                               torch.from_numpy(v).to(td), tpos, window=L)
    tol = 2e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("window", [0, 1000])
def test_blockwise_attention_matches_reference(window):
    B, S, H, KV, hd = 1, 2300, 2, 1, 16
    rng = np.random.default_rng(window)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    want = np.asarray(jax_blockwise(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    window=window))
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window)
    assert rel_err(got, want) <= 1e-5


def test_prefill_past_2048_tokens_takes_blockwise_attention(monkeypatch):
    """``attn_apply`` prefill at S > 2048 (the port refused it before)
    goes through blockwise attention and equals the reference's."""
    jcfg, tcfg = configs("float32", config="recurrentgemma")
    import dataclasses
    jcfg, tcfg = (dataclasses.replace(c, d_model=32, num_heads=2,
                                      num_kv_heads=1, head_dim=16)
                  for c in (jcfg, tcfg))
    jp = JA.attn_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = {n: torch.tensor(np.asarray(a)) for n, a in jp.items()}
    S, w = 2100, 1024
    x = _x((1, S, 32), 3)
    calls = []
    real = TA.blockwise_attention
    monkeypatch.setattr(TA, "blockwise_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    jy, jc = JA.attn_apply(jp, jnp.asarray(x), cfg=jcfg, ctx=auto_ctx(),
                           mode="prefill", window=w)
    with torch.no_grad():
        ty, tc = TA.attn_apply(tp, torch.from_numpy(x), cfg=tcfg,
                               mode="prefill", window=w)
    assert calls == [dict(causal=True, window=w)]
    assert rel_err(ty, jy) <= 1e-5
    assert tuple(tc["v"].shape) == jc["v"].shape == (1, w, 1, 16)
    assert all(rel_err(tc[n], jc[n]) <= 1e-6 for n in ("k", "v"))


def test_long_context_model_matches_reference():
    """Global attention given the smoke ``long_context_window`` (256):
    a 300-token prefill keeps a 256-slot ring, and decode wraps it."""
    jcfg, tcfg = configs("float32", config="internlm2")
    jmodel = jax_build_model(jcfg, auto_ctx(), long_context=True)
    jp = jmodel.init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    model = Model(tcfg, long_context=True)
    assert model.window_override == jmodel.window_override == 256
    assert Model(tcfg).window_override == 0
    B, P, MAX = 2, 300, 320
    toks = np.random.default_rng(5).integers(
        2, tcfg.vocab_size, (B, P)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill)(jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, tc = model.prefill(tp, torch.from_numpy(toks))
    assert rel_err(tl, jl) <= 1e-4
    assert tc["blocks"]["pos0"]["k"].shape[2] == 256
    cache = model.init_cache(B, MAX, device="cpu")
    assert cache["blocks"]["pos0"]["k"].shape[2] == 256
    for n, t in tc["blocks"]["pos0"].items():
        cache["blocks"]["pos0"][n].copy_(t)
    jcache = jc
    jdec = jax.jit(jmodel.decode_step)
    tok = np.argmax(to_np(jl), -1).astype(np.int32)
    for step in range(8):
        pos = np.full((B,), P + step, np.int32)
        jl, jcache = jdec(jp, jcache, jnp.asarray(tok[:, None]),
                          jnp.asarray(pos))
        with torch.no_grad():
            tl, cache = model.decode_step(tp, cache,
                                          torch.from_numpy(tok[:, None]),
                                          torch.from_numpy(pos))
        assert rel_err(tl, jl) <= 1e-4, step
        assert np.array_equal(np.argmax(to_np(tl), -1),
                              np.argmax(to_np(jl), -1))
        tok = np.argmax(to_np(jl), -1).astype(np.int32)
