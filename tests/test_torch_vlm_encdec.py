"""The VLM (Llama-3.2-Vision, smoke) and the encoder-decoder
(SeamlessM4T, smoke) through the port's model and engine, against the
JAX reference with the same weights and the same seeded memory.

* ``Model.prefill(memory=)`` then three greedy decode steps against the
  reference's jitted ``prefill`` / ``decode_step``, for the VLM, its
  G = 4 variant (8 query heads over 2 KV heads, as 32 over 8 at full
  width) and SeamlessM4T (whose encoder runs on the frames first):
  float32 greedy tokens equal and logits within 1e-4 relative, the
  caches too; bf16 within the 0.08 bar of
  ``tests/test_decode_consistency.py``, fed the reference's tokens.
* ``FlowServeEngine(memory=, device="cpu")`` against the reference's
  engine built on the Auto-axis mesh: the same greedy tokens.
* ``supports_chunked_prefill`` and ``supports_prefix_kv`` are false for
  both (prefill buffers), and a prefill without memory raises.
* The MTP head's kind rule: a cross-attention last mixer becomes
  (ATTN, MLP); the head's ``mtp_step`` with a decode cache against the
  reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import FlowServeEngine as JaxEngine
from repro_torch.configs.base import ATTN, MLP
from repro_torch.models.transformer import Model
from repro_torch.models.weights import flatten
from repro_torch.serving.backend import TorchBackend, _map_pairs
from repro_torch.serving.flowserve import FlowServeEngine
from torch_parity import auto_ctx, memory, reference, rel_err, to_np

B, P, MAX, STEPS = 2, 9, 32, 3
BAR = {"float32": 1e-4, "bfloat16": 0.08}
PROMPTS = ["describe the picture", "what does the speaker say",
           "a third request"]
N_NEW = 6


def _jax_flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", ["vision", "vision-gqa", "seamless"])
def test_prefill_and_greedy_decode_match_jax(config, dtype):
    jcfg, jmodel, jparams, tcfg, tparams = reference(dtype, config=config)
    model = Model(tcfg)
    mem = memory(tcfg, B, seed=2)
    toks = np.random.default_rng(4).integers(
        2, jcfg.vocab_size, (B, P)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks),
                                     jnp.asarray(mem, jmodel.dtype))
    with torch.no_grad():
        tl, tc = model.prefill(tparams, torch.from_numpy(toks),
                               memory=torch.from_numpy(mem))
    assert rel_err(tl, jl) <= BAR[dtype]
    jflat = _jax_flat(jc)
    for p, t in flatten(tc).items():
        assert rel_err(t, jflat[p]) <= BAR[dtype], p

    jc = jax.tree.map(lambda c, s: jnp.pad(
        c, [(0, st - ct) for ct, st in zip(c.shape, s.shape)]), jc,
        jmodel.cache_spec(B, MAX))
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


@pytest.mark.parametrize("config", ["vision-gqa", "seamless"])
def test_engine_matches_reference_engine(config):
    jcfg, _, jparams, tcfg, tparams = reference("float32", config=config)
    mem = memory(tcfg, 1, seed=6)
    kw = dict(n_dp_groups=2, max_batch=2, max_len=64)
    jeng = JaxEngine(jcfg, jparams, ctx=auto_ctx(),
                     memory=jnp.asarray(mem), **kw)
    teng = FlowServeEngine(tcfg, tparams, device="cpu",
                           memory=torch.from_numpy(mem), **kw)
    assert all(not d.backend.supports_chunked_prefill
               and not d.backend.supports_prefix_kv for d in teng.dps)
    outs = []
    for eng in (jeng, teng):
        reqs = [eng.submit_text(p, N_NEW, ignore_eos=True) for p in PROMPTS]
        eng.run_until_done()
        eng.close()
        outs.append([list(r.output_tokens) for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(t) == N_NEW for t in outs[1])


@pytest.mark.parametrize("config", ["vision", "seamless"])
def test_prefill_without_memory_raises(config):
    _, _, _, tcfg, tparams = reference("float32", config=config)
    model = Model(tcfg)
    with pytest.raises(ValueError, match="needs memory"):
        model.prefill(tparams, torch.tensor([[3, 4]]))
    be = TorchBackend(model, tparams, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="needs memory"):
        be.prefill([3, 4, 5])
    with pytest.raises(ValueError, match="chunked prefill"):
        model.prefill_chunk(tparams, model.init_cache(1, 32, device="cpu"),
                            torch.tensor([[3, 4]]), 0, torch.tensor([1]))


def test_mtp_head_takes_global_attention_in_place_of_cross():
    jcfg, jmodel, jparams, tcfg, tparams = reference("float32",
                                                     config="vision-mtp")
    model = Model(tcfg)
    assert tcfg.layer_pattern[-1][0] == "cross_attn"
    assert model.mtp_kind == (ATTN, MLP)
    got = flatten(tparams["mtp"])
    assert got["0.block.mixer.wk"].shape == (tcfg.d_model,
                                             tcfg.num_kv_heads,
                                             tcfg.resolved_head_dim)
    want = {p: (tuple(a.shape), str(a.dtype)) for p, a in
            flatten(jmodel.init_mtp_cache(B, MAX)).items()}
    cache = model.init_mtp_cache(B, MAX, device="cpu")
    assert want == {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                    for p, t in flatten(cache).items()}
    rng = np.random.default_rng(12)
    hidden = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    jkv = jmodel.init_mtp_cache(B, MAX)["kv"]
    jstep = jax.jit(jmodel.mtp_step, static_argnums=1)
    for step in range(STEPS):
        nxt = rng.integers(3, tcfg.vocab_size, (B, 1)).astype(np.int32)
        pos = np.full((B,), step, np.int32)
        jl, jh, jkv = jstep(jparams, 0, jnp.asarray(hidden),
                            jnp.asarray(nxt), jnp.asarray(pos), jkv)
        with torch.no_grad():
            tl, th, _ = model.mtp_step(tparams, 0,
                                       torch.from_numpy(hidden),
                                       torch.from_numpy(nxt),
                                       torch.from_numpy(pos), cache["kv"])
        assert rel_err(tl, jl) <= BAR["float32"], step
        assert rel_err(th, jh) <= BAR["float32"], step
        hidden = np.array(to_np(jh))
    for n, t in cache["kv"].items():
        assert rel_err(t, jkv[n]) <= BAR["float32"], n
