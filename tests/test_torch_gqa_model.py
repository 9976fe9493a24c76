"""Whole-model parity on the smoke Llama-4 (global GQA attention, a dense
MLP layer then a top-1 MoE layer with a shared expert) with G = 5 query
heads per KV head (``num_heads=10, num_kv_heads=2, head_dim=32``): the
port against the JAX reference with the same weights.

The weight bridge carries every leaf with no skip. float32: prefill
logits within 1e-4 relative, 8 greedy decode steps with identical
tokens and logits within 1e-4 relative, and a two-chunk prefill equal
to the monolithic one. bf16: logits within the 0.08 relative bar of
``tests/test_decode_consistency.py``, row by row. Top-1 routing is
discontinuous: where a row's two best experts are within 1e-2 of each
other in router probability, one-ulp differences of bf16 products
between the two frameworks may pick the other expert, and that row's
logits are then not held to the bar (the float32 test holds every
row)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ATTN, MOE
from repro_torch.models import ffn
from repro_torch.models.transformer import Model
from repro_torch.models.weights import flatten, from_jax_params
from torch_parity import reference, rel_err, to_np

CONFIG = "llama4-gqa"
B, PROMPT, MAX_LEN, STEPS = 2, 8, 16, 8
BAR = {"float32": 1e-4, "bfloat16": 0.08}
TIE = 1e-2       # router-probability gap under which bf16 may flip top-1


def _pad_jax(cache, L):
    """Pad the reference's prefill cache (``blocks`` leaves [n_sb, B, S,
    KV, hd]) to length ``L``."""
    def pad(a):
        w = [(0, 0)] * a.ndim
        w[2] = (0, L - a.shape[2])
        return jnp.pad(a, w)
    return jax.tree_util.tree_map(pad, cache)


def _pad_torch(model, cache1, L):
    full = model.init_cache(B, L, device="cpu")
    for pos, leaves in cache1["blocks"].items():
        for n, t in leaves.items():
            full["blocks"][pos][n][:, :, :t.shape[2]] = t
    return full


def test_config_is_gqa_with_a_moe_layer_that_is_not_a_suffix():
    _, _, _, tcfg, _ = reference("float32", config=CONFIG)
    assert tcfg.num_heads // tcfg.num_kv_heads == 5
    assert [k[0] for k in tcfg.layer_kinds()] == [ATTN, ATTN]
    assert [i for i, k in enumerate(tcfg.layer_kinds())
            if k[1] == MOE] == [1]
    assert tcfg.moe.top_k == 1 and not tcfg.prefix_layers


def test_bridge_carries_every_leaf_with_no_skip():
    _, _, jparams, tcfg, _ = reference("float32", config=CONFIG)
    assert "mtp" not in jparams
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    got = flatten(from_jax_params(tree, tcfg, "cpu"))
    want = flatten(tree)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(to_np(got[p]), to_np(want[p])) for p in want)


def _close_rows(tl, jl, gaps, dtype):
    """Each row's logits within the bar; in bf16 a row whose routing was
    a near tie (``gaps[i] < TIE``) is exempt."""
    for i in range(tl.shape[0]):
        if dtype == "bfloat16" and gaps[i] < TIE:
            continue
        assert rel_err(tl[i], jl[i]) <= BAR[dtype], f"row {i}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_greedy_decode_match_jax(dtype, monkeypatch):
    jcfg, jmodel, jparams, tcfg, tparams = reference(dtype, config=CONFIG)
    model = Model(tcfg)
    toks = np.random.default_rng(4).integers(
        2, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    route, gaps = ffn._route, []

    def spy(x, w, k):           # the router's top-2 gap of every token
        out = route(x, w, k)
        top2 = torch.topk(out[2], 2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).tolist())
        return out
    monkeypatch.setattr(ffn, "_route", spy)

    jl, jc = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        tl, tc = model.prefill(tparams, torch.from_numpy(toks))
    _close_rows(tl, to_np(jl), gaps[-1][PROMPT - 1::PROMPT], dtype)
    for pos, leaves in tc["blocks"].items():
        for n, t in leaves.items():
            assert rel_err(t, jc["blocks"][pos][n]) <= BAR[dtype], (pos, n)

    jdec = jax.jit(jmodel.decode_step)
    jc, tc = _pad_jax(jc, MAX_LEN), _pad_torch(model, tc, MAX_LEN)
    jtok = np.argmax(to_np(jl), -1).astype(np.int32)
    ttok = np.argmax(to_np(tl), -1).astype(np.int32)
    for step in range(STEPS):       # the last step writes slot MAX_LEN - 1
        if dtype == "float32":
            np.testing.assert_array_equal(ttok, jtok, err_msg=f"step {step}")
        pos = np.full((B,), PROMPT + step, np.int32)
        jl, jc = jdec(jparams, jc, jnp.asarray(jtok[:, None]),
                      jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = model.decode_step(tparams, tc,
                                       torch.from_numpy(jtok[:, None]),
                                       torch.from_numpy(pos))
        _close_rows(tl, to_np(jl), gaps[-1], dtype)
        jtok = np.argmax(to_np(jl), -1).astype(np.int32)
        ttok = np.argmax(to_np(tl), -1).astype(np.int32)
    for pos, leaves in tc["blocks"].items():     # the decode writes
        for n, t in leaves.items():
            assert rel_err(t, jc["blocks"][pos][n]) <= BAR[dtype], (pos, n)


def test_two_chunk_prefill_equals_monolithic_and_the_reference():
    jcfg, jmodel, jparams, tcfg, tparams = reference("float32",
                                                     config=CONFIG)
    model = Model(tcfg)
    L, cut = 12, 8
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        2, tcfg.vocab_size, (1, L)).astype(np.int64))
    with torch.no_grad():
        mono, mcache = model.prefill(tparams, toks)
        cache = model.init_cache(1, L, device="cpu")
        _, cache = model.prefill_chunk(tparams, cache, toks[:, :cut], 0,
                                       torch.tensor([cut - 1]))
        last, cache = model.prefill_chunk(tparams, cache, toks[:, cut:], cut,
                                          torch.tensor([L - cut - 1]))
    assert torch.equal(last, mono)
    for pos in ("pos0", "pos1"):
        for n in ("k", "v"):
            assert torch.equal(cache["blocks"][pos][n],
                               mcache["blocks"][pos][n])
    jcache = jmodel.init_cache(1, L)
    jchunk = jax.jit(jmodel.prefill_chunk)
    _, jcache = jchunk(jparams, jcache, jnp.asarray(toks[:, :cut].numpy()),
                       jnp.int32(0), jnp.asarray([cut - 1]))
    jlast, _ = jchunk(jparams, jcache, jnp.asarray(toks[:, cut:].numpy()),
                      jnp.int32(cut), jnp.asarray([L - cut - 1]))
    assert rel_err(last, jlast) <= 1e-4
