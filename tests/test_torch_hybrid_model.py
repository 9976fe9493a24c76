"""Whole-model parity of the recurrent and hybrid families, the chunked-
prefill rule, and the reference's pad folding, against the JAX
reference with the same weights.

* RecurrentGemma (smoke, 5 layers: RG-LRU, RG-LRU, ring-window attention
  in one superblock, then a 2-layer RG-LRU tail) and Mamba-2 (smoke):
  prefill, then 16 greedy decode steps (RecurrentGemma's cross its
  64-slot ring's wrap). float32: the same tokens, logits within 1e-4
  relative, the caches after decode too; bf16: logits within the 0.08
  relative bar of ``tests/test_decode_consistency.py``, fed the
  reference's tokens. The weight bridge carries every leaf, the tail's
  and the float32 ones (``gate_a_w``, ``lam``, ``a_log``, ``dt_bias``,
  ``d_skip``) included.
* ``TorchBackend.supports_chunked_prefill`` (and ``supports_prefix_kv``)
  against the reference's rule for every registered configuration, with
  and without long-context serving.
* The reference folds a bucket's pad tokens into the recurrent state,
  the conv history and (with a bucket past the window) the ring: the
  port's padded prefill equals the reference's padded one, and differs
  from the unpadded one, on purpose (ROADMAP "Known differences")."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models.transformer import build_model as jax_build_model
from repro.serving.backend import JAXBackend
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import (LOCAL_ATTN, NONE, RGLRU, SSM)
from repro_torch.models.transformer import Model
from repro_torch.models.weights import flatten, from_jax_params
from repro_torch.serving.backend import TorchBackend, _map_pairs
from torch_parity import auto_ctx, reference, rel_err, to_np

B, STEPS = 2, 16
#: prompt length and cache length per configuration: RecurrentGemma's
#: decode crosses its 64-slot ring at position 64; Mamba-2's prompt is
#: two SSD chunks of 32
SHAPES = {"recurrentgemma": (60, 96), "mamba2": (64, 96)}
BAR = {"float32": 1e-4, "bfloat16": 0.08}
F32_LEAVES = {"gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b", "lam",
              "a_log", "dt_bias", "d_skip"}


def _jax_flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_configs_have_the_families_layers():
    _, _, _, rg, _ = reference("float32", config="recurrentgemma")
    model = Model(rg)
    assert [k[0] for k in model.pattern] == [RGLRU, RGLRU, LOCAL_ATTN]
    assert model.n_sb == 1 and model.tail_kinds == ((RGLRU, "mlp"),) * 2
    _, _, _, mb, _ = reference("float32", config="mamba2")
    assert Model(mb).pattern == ((SSM, NONE),)


@pytest.mark.parametrize("config", ["recurrentgemma", "mamba2"])
def test_bridge_carries_every_leaf(config):
    _, _, jparams, tcfg, _ = reference("bfloat16", config=config)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    got = flatten(from_jax_params(tree, tcfg, "cpu"))
    want = flatten(tree)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(to_np(got[p]), to_np(want[p])) for p in want)
    for p, t in got.items():
        f32 = p.rsplit(".", 1)[-1] in F32_LEAVES or "norm" in p
        assert (t.dtype == torch.float32) == f32, p
    if config == "recurrentgemma":
        assert {p.split(".")[1] for p in got if p.startswith("tail.")} \
            == {"0", "1"}
    # the port's own random weights have the reference's leaves too
    spec = {p: (tuple(t.shape), t.dtype) for p, t in flatten(
        Model(tcfg).init(0, device="cpu")).items()}
    assert spec == {p: (tuple(t.shape), t.dtype) for p, t in got.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", ["recurrentgemma", "mamba2"])
def test_prefill_and_greedy_decode_match_jax(config, dtype):
    jcfg, jmodel, jparams, tcfg, tparams = reference(dtype, config=config)
    model = Model(tcfg)
    P, MAX = SHAPES[config]
    toks = np.random.default_rng(4).integers(
        2, jcfg.vocab_size, (B, P)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        tl, tc = model.prefill(tparams, torch.from_numpy(toks))
    assert rel_err(tl, jl) <= BAR[dtype]
    jflat = _jax_flat(jc)
    for p, t in flatten(tc).items():
        assert rel_err(t, jflat[p]) <= BAR[dtype], p

    spec = jmodel.cache_spec(B, MAX)
    jc = jax.tree.map(lambda c, s: jnp.pad(
        c, [(0, st - ct) for ct, st in zip(c.shape, s.shape)]), jc, spec)
    cache = model.init_cache(B, MAX, device="cpu")

    def fill(full, part, stacked):
        full[tuple(slice(0, n) for n in part.shape)] = part
    _map_pairs(fill, cache, tc)
    jdec = jax.jit(jmodel.decode_step)
    jtok = np.argmax(to_np(jl), -1).astype(np.int32)
    ttok = np.argmax(to_np(tl), -1).astype(np.int32)
    for step in range(STEPS):
        if dtype == "float32":
            np.testing.assert_array_equal(ttok, jtok, err_msg=f"step {step}")
        pos = np.full((B,), P + step, np.int32)
        jl, jc = jdec(jparams, jc, jnp.asarray(jtok[:, None]),
                      jnp.asarray(pos))
        with torch.no_grad():
            tl, cache = model.decode_step(tparams, cache,
                                          torch.from_numpy(jtok[:, None]),
                                          torch.from_numpy(pos))
        assert rel_err(tl, jl) <= BAR[dtype], step
        jtok = np.argmax(to_np(jl), -1).astype(np.int32)
        ttok = np.argmax(to_np(tl), -1).astype(np.int32)
    jflat = _jax_flat(jc)
    for p, t in flatten(cache).items():
        assert t.shape == jflat[p].shape
        assert rel_err(t, jflat[p]) <= BAR[dtype], p


def _jax_rule(cfg, long_context):
    """The reference's ``JAXBackend.supports_chunked_prefill``, on its
    own model object (no weights needed)."""
    model = jax_build_model(cfg, auto_ctx(), long_context=long_context)
    return JAXBackend.supports_chunked_prefill.fget(
        SimpleNamespace(model=model))


@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_chunked_prefill_rule_matches_reference(arch, long_context):
    assert arch in JAX_ARCHS
    tcfg = get_config(arch + "-smoke")
    want = _jax_rule(jax_get_config(arch + "-smoke"), long_context)
    if tcfg.is_encdec or any(m == "cross_attn"
                             for m, _ in tcfg.layer_kinds()):
        assert not want       # cross-attention and encoders buffer
    cfg = dataclasses.replace(tcfg, dtype="float32")
    model = Model(cfg, long_context=long_context)
    be = TorchBackend(model, model.init(0, device="cpu"), device="cpu")
    assert be.supports_chunked_prefill == want
    assert be.supports_prefix_kv == want


def _padded_pair(config, n):
    """(reference's padded prefill cache, port's padded, port's
    unpadded) of one ``n``-token prompt, as numpy trees."""
    jcfg, jmodel, jparams, tcfg, tparams = reference("float32",
                                                     config=config)
    toks = np.random.default_rng(n).integers(
        3, tcfg.vocab_size, n).tolist()
    jc, jlog = JAXBackend(jmodel, jparams, max_len=256).prefill(toks)
    be = TorchBackend(Model(tcfg), tparams, max_len=256, device="cpu")
    tc, tlog = be.prefill(toks)
    with torch.no_grad():
        ul, uc = Model(tcfg).prefill(tparams, torch.tensor([toks]))
    # the logits at the last real token are the same padded or not
    assert rel_err(tlog, jlog) <= 1e-4 and rel_err(ul[0], tlog) <= 1e-4
    return _jax_flat(jc), flatten(tc), flatten(uc)


@pytest.mark.parametrize("config,n,leaf", [
    ("recurrentgemma", 20, "blocks.pos0.state"),   # bucket 32
    ("recurrentgemma", 20, "tail.1.conv"),
    ("recurrentgemma", 70, "blocks.pos2.k"),       # bucket 128 > window 64
    ("mamba2", 20, "blocks.pos0.state"),
    ("mamba2", 20, "blocks.pos0.conv")])
def test_padded_prefill_folds_the_pads_as_the_reference(config, n, leaf):
    jflat, padded, unpadded = _padded_pair(config, n)
    assert rel_err(padded[leaf], jflat[leaf]) <= 1e-5
    p, u = padded[leaf], unpadded[leaf]
    if p.shape != u.shape:                 # k of 20 real vs 32 slots
        p = p[tuple(slice(0, s) for s in u.shape)]
    assert float((p - u).abs().max()) > 1e-2 * float(u.abs().max())
