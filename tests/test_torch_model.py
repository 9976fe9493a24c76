"""Whole-model parity on the smoke DeepSeek-V3 (3 dense MLA+MLP layers,
then MLA+MoE superblocks): the port against the JAX reference with the
same weights. float32: prefill logits within 1e-4 relative, 8 greedy
decode steps with identical tokens and logits within 1e-4 relative.
bf16: logits within the 0.08 relative bar of
``tests/test_decode_consistency.py``. Chunked prefill is bit-identical
to monolithic prefill, as in the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.transformer import Model
from torch_parity import reference, rel_err, to_np

B, PROMPT, MAX_LEN, STEPS = 2, 8, 16, 8
BAR = {"float32": 1e-4, "bfloat16": 0.08}


def _pad_jax(cache, L):
    def pad(path, a):
        ax = 2 if any(getattr(p, "key", None) == "blocks" for p in path) \
            else 1
        w = [(0, 0)] * a.ndim
        w[ax] = (0, L - a.shape[ax])
        return jnp.pad(a, w)
    return jax.tree_util.tree_map_with_path(pad, cache)


def _pad_torch(model, cache1, L):
    full = model.init_cache(B, L, device="cpu")
    for i, layer in enumerate(cache1["prefix"]):
        for n, t in layer.items():
            full["prefix"][i][n][:, :t.shape[1]] = t
    for pos, leaves in cache1["blocks"].items():
        for n, t in leaves.items():
            full["blocks"][pos][n][:, :, :t.shape[2]] = t
    return full


@pytest.mark.parametrize("num_layers,dtype", [(4, "float32"),
                                              (5, "float32"),
                                              (4, "bfloat16"),
                                              (5, "bfloat16")])
def test_prefill_and_greedy_decode_match_jax(num_layers, dtype):
    jcfg, jmodel, jparams, tcfg, tparams = reference(dtype, num_layers)
    model = Model(tcfg)
    assert model.n_sb == num_layers - 3
    toks = np.random.default_rng(num_layers).integers(
        2, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)

    jl, jc = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        tl, tc = model.prefill(tparams, torch.from_numpy(toks))
    assert rel_err(tl, jl) <= BAR[dtype]

    jdec = jax.jit(jmodel.decode_step)
    jc, tc = _pad_jax(jc, MAX_LEN), _pad_torch(model, tc, MAX_LEN)
    jtok = np.argmax(to_np(jl), -1).astype(np.int32)
    ttok = np.argmax(to_np(tl), -1).astype(np.int32)
    for step in range(STEPS):
        if dtype == "float32":
            np.testing.assert_array_equal(ttok, jtok, err_msg=f"step {step}")
        pos = np.full((B,), PROMPT + step, np.int32)
        jl, jc = jdec(jparams, jc, jnp.asarray(jtok[:, None]),
                      jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = model.decode_step(tparams, tc,
                                       torch.from_numpy(jtok[:, None]),
                                       torch.from_numpy(pos))
        assert rel_err(tl, jl) <= BAR[dtype], f"step {step}"
        jtok = np.argmax(to_np(jl), -1).astype(np.int32)
        ttok = np.argmax(to_np(tl), -1).astype(np.int32)


@pytest.mark.parametrize("num_layers", [4, 5])
def test_two_chunk_prefill_equals_monolithic(num_layers):
    jcfg, jmodel, jparams, tcfg, tparams = reference("float32", num_layers)
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
    for n in ("ckv", "krope"):
        assert torch.equal(cache["prefix"][0][n], mcache["prefix"][0][n])
        assert torch.equal(cache["blocks"]["pos0"][n],
                           mcache["blocks"]["pos0"][n])
    # and the chunked logits match the reference's chunked prefill
    jcache = jmodel.init_cache(1, L)
    jchunk = jax.jit(jmodel.prefill_chunk)
    _, jcache = jchunk(jparams, jcache, jnp.asarray(toks[:, :cut].numpy()),
                       jnp.int32(0), jnp.asarray([cut - 1]))
    jlast, _ = jchunk(jparams, jcache, jnp.asarray(toks[:, cut:].numpy()),
                      jnp.int32(cut), jnp.asarray([L - cut - 1]))
    assert rel_err(last, jlast) <= 1e-4


def test_bridge_rejects_missing_and_unexpected_leaves():
    """The MTP head is carried like every other subtree: an extra leaf
    beside it, a missing leaf of it or of the main stack, each raises."""
    from repro_torch.models.weights import from_jax_params
    jcfg, jmodel, jparams, tcfg, _ = reference("float32")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    assert "mtp" in tree
    from_jax_params(tree, tcfg, "cpu")
    extra = dict(tree, mtp=tree["mtp"] + (tree["mtp"][0],))
    with pytest.raises(KeyError, match=r"unexpected \['mtp\.1\."):
        from_jax_params(extra, tcfg, "cpu")
    head = dict(tree["mtp"][0])
    del head["proj"]
    with pytest.raises(KeyError, match=r"missing \['mtp\.0\.proj'\]"):
        from_jax_params(dict(tree, mtp=(head,)), tcfg, "cpu")
    del tree["final_norm"]
    with pytest.raises(KeyError, match="missing"):
        from_jax_params(tree, tcfg, "cpu")
