"""Parity of the registered configurations that no other port test holds
to the reference: Granite-8B and Mistral-NeMo-12B (dense GQA, G = 4 as
at full width), Command-R-35B (G = 8, and the one config whose
``lm_head`` is the transposed embedding) and DeepSeek-MoE-16B (MHA, a
dense prefix layer, then MoE with shared experts), at smoke size.

float32: prefill logits within 1e-4 relative of the reference's, and
the port's ``FlowServeEngine`` (two DP groups) gives the reference
engine's greedy tokens over 9 new tokens (8 decode steps). bf16: the
port's decode against its own prefill of the longer prompt within the
0.08 bar of ``tests/test_decode_consistency.py``. Command-R's tied
head: the weight bridge maps a tree with no ``lm_head`` leaf (and still
refuses a missing or an unexpected leaf), and the train-mode gradient
of ``embed`` (its use as the embedding plus its use as the head) is
the reference's ``jax.grad`` within 2e-4. A 4096-slot buffer: a
Mistral-NeMo engine prefills a 3000-token prompt in 512-token chunks,
each attending the whole buffer, and decodes the reference's tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import ATTN, MLP, MOE
from repro_torch.models.transformer import Model
from repro_torch.models.weights import flatten, from_jax_params
from repro_torch.serving.backend import _map_pairs
from repro_torch.serving.flowserve import FlowServeEngine
from repro_torch.serving.request import Request
from test_torch_train_model import (batch, jax_loss_grads, rel_norm,
                                    torch_loss_grads)
from torch_parity import (configs, jax_engine, one_thread,  # noqa: F401
                          reference, rel_err, to_np)

HELD = ["granite", "mistral-nemo", "command-r", "deepseek-moe"]
#: query heads per KV head of each smoke config: the full-width G
G = {"granite": 4, "mistral-nemo": 4, "command-r": 8, "deepseek-moe": 1}
PROMPTS = ["hello world", "the quick brown fox jumps", "a"]
NEW = 9                      # the first token, then 8 decode steps
GRAD_BAR = 2e-4


@pytest.fixture(scope="module")
def ref():
    """The float32 reference of each config, built once for the file."""
    return {c: reference("float32", config=c, jit_init=True) for c in HELD}


def _serve(engine, request_cls, prompts=PROMPTS, n=NEW, tokens=None):
    reqs = [request_cls(prompt=p, max_new_tokens=n, ignore_eos=True,
                        prompt_tokens=None if tokens is None else tokens[i])
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    return [list(r.output_tokens) for r in reqs]


@pytest.mark.parametrize("config", HELD)
def test_config_keeps_the_full_width_structure(config, ref):
    jcfg, _, jparams, tcfg, _ = ref[config]
    assert tcfg.num_heads // tcfg.num_kv_heads == G[config]
    assert jcfg.num_heads // jcfg.num_kv_heads == G[config]
    kinds = tcfg.layer_kinds()
    assert all(m == ATTN for m, _ in kinds)
    if config == "deepseek-moe":
        assert [f for _, f in kinds] == [MLP, MOE]
        assert tcfg.moe.num_shared_experts == 1
    else:
        assert all(f == MLP for _, f in kinds)
    assert tcfg.tie_embeddings == (config == "command-r")
    assert ("lm_head" in jparams) == (config != "command-r")


def test_tied_head_bridge_maps_a_tree_with_no_lm_head_and_refuses_others(
        ref):
    _, _, jparams, tcfg, tparams = ref["command-r"]
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    assert "lm_head" not in tree and "lm_head" not in tparams
    got, want = flatten(from_jax_params(tree, tcfg, "cpu")), flatten(tree)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(to_np(got[p]), to_np(want[p])) for p in want)
    extra = dict(tree, lm_head=tree["embed"].T.copy())
    with pytest.raises(KeyError, match="unexpected \\['lm_head'\\]"):
        from_jax_params(extra, tcfg, "cpu")
    missing = {k: v for k, v in tree.items() if k != "embed"}
    with pytest.raises(KeyError, match="missing \\['embed'\\]"):
        from_jax_params(missing, tcfg, "cpu")
    # an untied model still needs its lm_head
    untied = dataclasses.replace(tcfg, tie_embeddings=False)
    with pytest.raises(KeyError, match="missing \\['lm_head'\\]"):
        from_jax_params(tree, untied, "cpu")


@pytest.mark.parametrize("config", HELD)
def test_prefill_logits_match_reference(config, ref):
    jcfg, jmodel, jparams, tcfg, tparams = ref[config]
    toks = np.random.default_rng(7).integers(
        2, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, _ = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = Model(tcfg).prefill(tparams, torch.from_numpy(toks))
    assert tl.shape == (2, tcfg.vocab_size)
    assert rel_err(tl, jl) <= 1e-4


@pytest.mark.parametrize("config", HELD)
def test_engine_greedy_tokens_equal_reference(config, ref):
    jcfg, jmodel, jparams, tcfg, tparams = ref[config]
    jeng = jax_engine(jmodel, jparams, n_dp_groups=2, max_batch=2)
    want = _serve(jeng, JaxRequest)
    jeng.close()
    teng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=2,
                           max_batch=2)
    got = _serve(teng, Request)
    steps = [d.steps for d in teng.dps]
    teng.close()
    assert got == want
    assert all(len(t) == NEW for t in got)
    assert max(steps) >= NEW - 1            # 8 decode steps at least


@pytest.mark.parametrize("config", HELD)
def test_bf16_decode_matches_prefill(config):
    """The port's own prefill → decode equivalence in bf16, as
    ``tests/test_decode_consistency.py`` holds the reference's."""
    _, tcfg = configs("bfloat16", config=config)
    model = Model(tcfg)
    params = model.init(3, device="cpu")
    B, S, MAX, STEPS = 2, 24, 32, 3
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, S + STEPS)).astype(np.int64))
    with torch.no_grad():
        _, part = model.prefill(params, toks[:, :S])
        cache = model.init_cache(B, MAX, device="cpu")

        def fill(full, one, stacked):
            full[tuple(slice(0, n) for n in one.shape)] = one
        _map_pairs(fill, cache, part)
        for step in range(STEPS):
            want, _ = model.prefill(params, toks[:, :S + step + 1])
            got, cache = model.decode_step(
                params, cache, toks[:, S + step:S + step + 1].int(),
                torch.full((B,), S + step, dtype=torch.int32))
            assert rel_err(got, want) < 0.08, (config, step)


def test_tied_embed_gradient_matches_reference(ref):
    """Command-R's ``embed`` gradient is the sum of its two uses: rows of
    ids the batch never holds get the head's part only (non-zero), and
    every leaf is the reference's ``jax.grad`` within 2e-4."""
    jcfg, jmodel, jparams, tcfg, tparams = ref["command-r"]
    toks, labels, mask = batch(jcfg, 2, 40, seed=5)
    jl, jm, jg = jax_loss_grads(jmodel, jparams, toks, labels, mask, None)
    tl, tm, tg = torch_loss_grads(Model(tcfg), tparams, toks, labels, mask,
                                  None)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert set(tg) == set(jg) and "lm_head" not in tg
    errs = {k: rel_norm(tg[k], jg[k]) for k in jg}
    assert errs["embed"] <= GRAD_BAR, errs["embed"]
    assert max(errs.values()) <= GRAD_BAR, max(errs, key=errs.get)
    unseen = np.setdiff1d(np.arange(jcfg.vocab_size), toks)
    assert unseen.size and (np.abs(tg["embed"][unseen]).sum(-1) > 0).all()


def test_long_buffer_chunked_prefill_equals_reference(ref):
    """Mistral-NeMo on a 4096-slot buffer: a 3000-token prompt in
    512-token chunks (six chunks, each over the whole buffer) beside a
    short one, greedy tokens equal to the reference's."""
    jcfg, jmodel, jparams, tcfg, tparams = ref["mistral-nemo"]
    rng = np.random.default_rng(3000)
    tokens = [rng.integers(3, jcfg.vocab_size, n).tolist()
              for n in (3000, 40)]
    kw = dict(n_dp_groups=1, max_batch=2, max_len=4096, chunk_tokens=512)
    jeng = jax_engine(jmodel, jparams, **kw)
    want = _serve(jeng, JaxRequest, ["long", "short"], 8, tokens)
    jeng.close()
    teng = FlowServeEngine(tcfg, tparams, device="cpu", **kw)
    chunks = []
    real = teng.dps[0].backend.prefill_chunk

    def spy(cache, toks, offset, total_len):
        chunks.append((offset, len(toks), total_len))
        return real(cache, toks, offset, total_len)
    teng.dps[0].backend.prefill_chunk = spy
    got = _serve(teng, Request, ["long", "short"], 8, tokens)
    teng.close()
    assert got == want
    long_chunks = [c for c in chunks if c[2] == 3000]
    assert [o for o, _, _ in long_chunks] == list(range(0, 3000, 512))
