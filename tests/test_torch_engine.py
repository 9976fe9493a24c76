"""The port's FlowServe engine against the reference engine, the decode
host-transfer budget, and on-device sampling.

Greedy output must be token-identical to the JAX engine's (smoke
DeepSeek-V3, float32, same weights) before and after an EPLB pass that
installs redundant replicas; stochastic sampling is held only to its
distribution, because the two random number generators differ."""
import numpy as np
import pytest
import torch

from repro.serving.flowserve import FlowServeEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import MOE
from repro_torch.models.common import tree_map
from repro_torch.models.weights import flatten
from repro_torch.serving import dp_group as tdp
from repro_torch.serving.flowserve import FlowServeEngine
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import (sample_host, sample_tokens,
                                          step_generator, top_k_mask)
from torch_parity import auto_ctx, reference

PROMPTS = ["hello world", "the quick brown fox jumps", "a"]


def _skewed_counts(cfg):
    """Routed-token counts with one hot expert in every MoE layer."""
    moe = [i for i, (_, f) in enumerate(cfg.layer_kinds()) if f == MOE]
    counts = np.zeros((cfg.num_layers, cfg.moe.num_experts), np.int64)
    counts[moe, 1] = 100
    counts[moe, 0] = 5
    return counts


def _serve(engine, request_cls):
    reqs = [request_cls(prompt=p, max_new_tokens=8, ignore_eos=True)
            for p in PROMPTS]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    return [list(r.output_tokens) for r in reqs]


def _two_rounds(engine, request_cls, cfg):
    first = _serve(engine, request_cls)
    engine.record_expert_counts(_skewed_counts(cfg))
    maps = engine.run_eplb()
    assert any(len(s) > 1 for m in maps.values() for s in m.replicas.values())
    second = _serve(engine, request_cls)
    return first, second


def test_engine_greedy_tokens_identical_to_reference_before_and_after_eplb():
    jcfg, _, jparams, tcfg, tparams = reference("float32")
    jeng = JaxEngine(jcfg, jparams, ctx=auto_ctx(), n_dp_groups=2,
                     max_batch=2)
    want = _two_rounds(jeng, JaxRequest, jcfg)
    jeng.close()
    teng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=2,
                           max_batch=2)
    got = _two_rounds(teng, Request, tcfg)
    assert all(d.backend._placement is not None for d in teng.dps)
    # one parameter set serves every DP group
    assert all(d.backend.params is teng.params for d in teng.dps)
    teng.close()
    assert got == want
    assert all(len(t) == 8 for rnd in got for t in rnd)


@pytest.mark.parametrize("chunk_tokens", [None, 8])
def test_llama4_gqa_engine_greedy_tokens_identical_to_reference(
        chunk_tokens, monkeypatch):
    """The smoke Llama-4 with G = 5 (GQA, a dense layer then a top-1 MoE
    layer): each prompt prefilled as one chunk, and in 8-token chunks
    (``attn_apply(mode="chunk")`` at offsets past 0); before and after
    EPLB replicates an expert of the MoE layer (layer 1)."""
    from repro_torch.models import attention
    jcfg, _, jparams, tcfg, tparams = reference("float32",
                                                config="llama4-gqa")
    jeng = JaxEngine(jcfg, jparams, ctx=auto_ctx(), n_dp_groups=2,
                     max_batch=2, chunk_tokens=chunk_tokens)
    want = _two_rounds(jeng, JaxRequest, jcfg)
    jeng.close()
    modes, apply = [], attention.attn_apply

    def spy(*a, mode, **kw):
        modes.append((mode, kw["positions"] if mode == "chunk" else None))
        return apply(*a, mode=mode, **kw)
    monkeypatch.setattr(attention, "attn_apply", spy)
    teng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=2,
                           max_batch=2, chunk_tokens=chunk_tokens)
    got = _two_rounds(teng, Request, tcfg)
    table = teng.dps[0].backend._placement
    teng.close()
    assert got == want
    assert all(len(t) == 8 for rnd in got for t in rnd)
    # EPLB replicated an expert of the MoE layer only
    n_rep = table.n_replicas.numpy()
    assert n_rep[1].max() > 1 and n_rep[0].max() == 1
    offsets = {o for m, o in modes if m == "chunk"}
    assert 0 in offsets and (max(offsets) > 0) == (chunk_tokens is not None)
    assert ("decode", None) in modes


def test_decode_step_moves_only_token_ids(monkeypatch):
    _, _, _, tcfg, tparams = reference("float32")
    eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=1,
                          max_batch=3)
    moved = []
    real = tdp.to_host

    def spy(t):
        moved.append((tuple(t.shape), t.dtype))
        return real(t)
    monkeypatch.setattr(tdp, "to_host", spy)
    for dp in eng.dps:
        dp.backend.decode = lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("[B, V] logits path used on the decode loop"))
    _serve(eng, Request)
    eng.close()
    assert len(moved) == 7          # one fetch per decode iteration
    assert all(m == ((3,), torch.int32) for m in moved)   # 4·B bytes


def test_greedy_sampling_is_argmax_first_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [0.5, 0.1, 0.5, 0.2]])
    toks = sample_tokens(logits, torch.zeros(2), step_generator(0, 0, "cpu"))
    assert toks.tolist() == [1, 0] and toks.dtype == torch.int32


@pytest.mark.parametrize("temperature", [0.7, 1.5])
def test_temperature_sampling_distribution(temperature):
    logits = torch.tensor([2.0, 1.0, 0.0, -1.0])
    n = 4000
    toks = sample_tokens(logits.repeat(n, 1), torch.full((n,), temperature),
                         step_generator(3, 7, "cpu"))
    emp = np.bincount(toks.numpy(), minlength=4) / n
    want = torch.softmax(logits / temperature, -1).numpy()
    np.testing.assert_allclose(emp, want, atol=0.03)
    rng = np.random.default_rng(5)
    host = np.bincount([sample_host(logits.numpy(), temperature, rng)
                        for _ in range(n)], minlength=4) / n
    np.testing.assert_allclose(host, want, atol=0.03)


def test_sampling_stream_is_a_function_of_seed_and_step():
    logits = torch.randn(4, 32, generator=torch.Generator().manual_seed(2))
    temps = torch.full((4,), 0.8)
    a = sample_tokens(logits, temps, step_generator(11, 5, "cpu"))
    b = sample_tokens(logits, temps, step_generator(11, 5, "cpu"))
    c = sample_tokens(logits, temps, step_generator(11, 6, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    masked = top_k_mask(torch.tensor([[5.0, 4.0, 3.0, 2.0]]), 2)
    assert (masked[0, 2:] < -1e29).all()
    toks = sample_tokens(torch.tensor([[5.0, 4.0, 3.0, 2.0]]).repeat(64, 1),
                         torch.full((64,), 2.0), step_generator(0, 0, "cpu"),
                         top_k=2)
    assert set(toks.tolist()) <= {0, 1}


def test_fault_rollback_reexecutes_the_step_identically():
    """§6.2 token recomputation: a step run with ``donate=False``, rolled
    back and re-run gives the tokens of an ordinary step, and leaves the
    pre-step cache untouched."""
    _, _, _, tcfg, tparams = reference("float32")
    outs = []
    for fault in (False, True):
        eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=1,
                              max_batch=2)
        reqs = [Request(prompt=p, max_new_tokens=6, ignore_eos=True)
                for p in PROMPTS[:2]]
        for r in reqs:
            eng.submit(r)
        eng.step()                       # prefill + admit + one decode
        dp = eng.dps[0]
        for _ in range(3):
            assert dp.decode_step_all(inject_fault=fault) == 2
        before = flatten(tree_map(torch.clone, dp.cache))
        toks, pos, temps, _ = dp._gather_step_inputs()
        _, after = dp.backend.decode_sample(dp.cache, toks, pos, temps,
                                            dp.steps, donate=False)
        assert all(torch.equal(t, before[k])
                   for k, t in flatten(dp.cache).items())
        assert not all(torch.equal(t, before[k])
                       for k, t in flatten(after).items())
        dp.drain()
        outs.append([list(r.output_tokens) for r in reqs])
        eng.close()
    assert outs[0] == outs[1]


def test_placement_table_with_out_of_range_ids_is_refused():
    from repro_torch.serving.eplb import identity_placement
    _, _, _, tcfg, tparams = reference("float32")
    eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=1)
    table = identity_placement(tcfg.num_layers, tcfg.moe.num_experts,
                               pad_physical=tcfg.moe.num_experts + 1)
    table.phys_owner[0, -1] = tcfg.moe.num_experts      # no such expert
    with pytest.raises(ValueError, match="out-of-range"):
        eng.dps[0].backend.apply_placement(table)
    eng.close()
