"""MTP speculative decoding (§4.6) through the port's FlowServe engine,
on the smoke DeepSeek-V3 in float32.

Greedy tokens with ``mtp_k=2`` equal the port's plain engine's and the
reference engine's (with ``mtp_k=2`` too), before and after an EPLB
pass. The DP group's bookkeeping: host traffic of ``4·B·(k+1) + 4·B``
bytes an iteration, the head's state reset at admission, a stop (EOS or
budget) in the middle of a block truncates it, and a rolled-back
iteration replays its blocks and draws. With an oracle head (logits
peaked at the plain chain's next token, see
``tests/test_torch_mtp_backend.py``) every iteration accepts all ``k``
drafts and emits ``k + 1`` tokens, the stream unchanged."""
import numpy as np
import pytest
import torch

from repro.serving.flowserve import FlowServeEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import MOE
from repro_torch.serving import dp_group as tdp
from repro_torch.serving.flowserve import FlowServeEngine
from repro_torch.serving.request import Request
from test_torch_mtp_backend import torch_oracle
from torch_parity import auto_ctx, reference, to_np

PROMPTS = ["hello world", "the quick brown fox jumps", "a"]


@pytest.fixture(scope="module")
def ref():
    return reference("float32")


def _serve(engine, request_cls, n=8, prompts=PROMPTS, **kw):
    reqs = [request_cls(prompt=p, max_new_tokens=n, ignore_eos=True, **kw)
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    return [list(r.output_tokens) for r in reqs]


def _two_rounds(engine, request_cls, cfg):
    first = _serve(engine, request_cls)
    counts = np.zeros((cfg.num_layers, cfg.moe.num_experts), np.int64)
    moe = [i for i, (_, f) in enumerate(cfg.layer_kinds()) if f == MOE]
    counts[moe, 1], counts[moe, 0] = 100, 5
    engine.record_expert_counts(counts)
    assert engine.run_eplb()
    return first, _serve(engine, request_cls)


class Spy:
    """Wraps a DP group's backend's ``decode_sample_mtp``: keeps every
    call's block and accepted counts on the host, and which slots were
    busy."""

    def __init__(self, dp):
        self.dp, self.real = dp, dp.backend.decode_sample_mtp
        self.calls, self.busy = [], []
        dp.backend.decode_sample_mtp = self

    def __call__(self, *a, **kw):
        out = self.real(*a, **kw)
        self.calls.append((to_np(out[0]).copy(), to_np(out[1]).copy()))
        self.busy.append(np.array([not s.free for s in self.dp.slots]))
        return out

    def accepted(self) -> np.ndarray:
        """Accepted counts of the busy slots, call by call."""
        return [n[b] for (_, n), b in zip(self.calls, self.busy)]


def test_greedy_tokens_equal_plain_and_reference_before_and_after_eplb(ref):
    jcfg, _, jparams, tcfg, tparams = ref
    jeng = JaxEngine(jcfg, jparams, ctx=auto_ctx(), n_dp_groups=2,
                     max_batch=2, mtp_k=2)
    want = _two_rounds(jeng, JaxRequest, jcfg)
    jeng.close()
    outs = {}
    for k in (0, 2):
        eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=2,
                              max_batch=2, mtp_k=k)
        assert all(d.mtp_k == k and (d.mtp_cache is None) == (k == 0)
                   for d in eng.dps)
        spies = [Spy(d) for d in eng.dps] if k else []
        outs[k] = _two_rounds(eng, Request, tcfg)
        assert all(d.backend._placement is not None for d in eng.dps)
        eng.close()
        assert all(s.calls for s in spies)
    assert outs[2] == outs[0] == want
    assert all(len(t) == 8 for rnd in outs[2] for t in rnd)


def test_mtp_decode_moves_only_token_ids(ref, monkeypatch):
    _, _, _, tcfg, tparams = ref
    k, B = 2, 3
    eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=1,
                          max_batch=B, mtp_k=k)
    moved = []
    real = tdp.to_host

    def spy(t):
        moved.append((tuple(t.shape), t.dtype))
        return real(t)
    monkeypatch.setattr(tdp, "to_host", spy)
    for dp in eng.dps:
        for name in ("decode", "decode_sample"):
            setattr(dp.backend, name, lambda *a, **kw: (_ for _ in ()).throw(
                AssertionError("a one-token or logits path used")))
    _serve(eng, Request)
    eng.close()
    # per iteration: the [B, k+1] block and the [B] counts, int32
    assert len(moved) == 14
    assert moved[0::2] == [((B, k + 1), torch.int32)] * 7
    assert moved[1::2] == [((B,), torch.int32)] * 7
    assert 4 * B * (k + 1) + 4 * B == 48


def test_admission_resets_the_slots_head_state(ref):
    _, _, _, tcfg, tparams = ref
    eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=1,
                          max_batch=2, mtp_k=1)
    dp = eng.dps[0]
    resets, real = [], dp.backend.reset_mtp_slot

    def spy(mtp_cache, slot):
        resets.append(slot)
        assert mtp_cache is dp.mtp_cache
        return real(mtp_cache, slot)
    dp.backend.reset_mtp_slot = spy
    _serve(eng, Request, n=4, prompts=PROMPTS[:2])
    assert sorted(resets) == [0, 1]
    # the head's state of both slots holds the served requests' content;
    # a third request admitted into slot 0 starts from zeros there
    assert dp.mtp_cache["hidden"].abs().sum(-1).min() > 0
    before = {n: t[1].clone() for n, t in dp.mtp_cache["kv"].items()}
    req = Request(prompt="x", max_new_tokens=4, ignore_eos=True)
    cache1, logits = dp.backend.prefill(dp.tokenizer.encode("x"))
    req.prompt_tokens = dp.tokenizer.encode("x")
    dp.admit(req, cache1, logits)
    assert resets[-1] == 0 and not dp.mtp_cache["hidden"][0].any()
    assert all(not t[0].any() for t in dp.mtp_cache["kv"].values())
    assert all(torch.equal(t[1], before[n])
               for n, t in dp.mtp_cache["kv"].items())
    eng.close()


def _plain(tcfg, tparams, n, prompts=PROMPTS):
    eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=1,
                          max_batch=len(prompts))
    out = _serve(eng, Request, n=n, prompts=prompts)
    eng.close()
    return dict(zip(prompts, out))


def _oracle_engine(monkeypatch, tcfg, tparams, k, plain, wrong=()):
    """An MTP engine whose head proposes the plain chain's next token
    (``wrong``: (prompt, output index) pairs it gets wrong)."""
    eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=1,
                          max_batch=len(PROMPTS), mtp_k=k)
    slots = eng.dps[0].slots

    def target_of(b, q):
        req = slots[b].req
        if req is None:
            return 0
        i = q - req.prompt_len
        out = plain[req.prompt]
        tok = out[i] if 0 <= i < len(out) else 0
        return tok + 1 if (req.prompt, i) in wrong else tok
    torch_oracle(monkeypatch, eng.model, target_of)
    return eng, Spy(eng.dps[0])


@pytest.mark.parametrize("k", [1, 2])
def test_oracle_head_accepts_every_draft_losslessly(ref, monkeypatch, k):
    _, _, _, tcfg, tparams = ref
    n = 7                               # 6 decoded: whole blocks
    plain = _plain(tcfg, tparams, n + 2 * k + 2)
    eng, spy = _oracle_engine(monkeypatch, tcfg, tparams, k, plain)
    got = _serve(eng, Request, n=n)
    eng.close()
    assert got == [plain[p][:n] for p in PROMPTS]
    n_acc = np.stack(spy.accepted())
    assert (n_acc == k).all() and len(spy.calls) == (n - 1) // (k + 1)
    # tokens a slot emits per iteration (the MTPStats metric)
    assert float(np.mean(n_acc + 1)) == k + 1


def test_oracle_head_rejects_a_draft_mid_block(ref, monkeypatch):
    _, _, _, tcfg, tparams = ref
    k, n = 2, 9
    plain = _plain(tcfg, tparams, n + 2 * k + 2)
    # the second iteration's second draft of the first prompt is wrong
    eng, spy = _oracle_engine(monkeypatch, tcfg, tparams, k, plain,
                              wrong={(PROMPTS[0], 5)})
    got = _serve(eng, Request, n=n)
    eng.close()
    assert got == [plain[p][:n] for p in PROMPTS]
    n_acc = spy.accepted()
    assert n_acc[0].tolist() == [k] * 3
    assert sorted(n_acc[1].tolist()) == [1, k, k]


@pytest.mark.parametrize("stop", ["eos", "budget"])
def test_a_stop_mid_block_truncates_it(ref, monkeypatch, stop):
    _, _, _, tcfg, tparams = ref
    k = 2
    plain = _plain(tcfg, tparams, 16)
    eng, spy = _oracle_engine(monkeypatch, tcfg, tparams, k, plain)
    reqs = []
    for p in PROMPTS:
        out = plain[p]
        if stop == "eos":          # the middle token of the second block
            eos = out[5]
            end = 1 + next(i for i in range(1, 16) if out[i] == eos)
            r = Request(prompt=p, max_new_tokens=16, eos_token=eos)
        else:
            end = 6
            r = Request(prompt=p, max_new_tokens=end, ignore_eos=True)
        reqs.append((r, out[:end]))
        eng.submit(r)
    eng.run_until_done()
    eng.close()
    for r, want in reqs:
        assert r.output_tokens == want and r.state.value == "finished"
    assert all(s.free for s in eng.dps[0].slots)
    assert all((n == k).all() for n in spy.accepted())


def test_mtp_rollback_replays_identically(ref):
    """§6.2 under MTP: each faulted iteration runs the step, rolls both
    caches back and runs it again; the blocks and counts of both runs
    equal those of the fault-free iteration from the same state, greedy
    and at temperature 0.7 (the draws replay), and so do the tokens."""
    _, _, _, tcfg, tparams = ref
    runs = []
    for fault in (False, True):
        eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=1,
                              max_batch=2, mtp_k=2)
        reqs = [Request(prompt=PROMPTS[0], max_new_tokens=10,
                        ignore_eos=True),
                Request(prompt=PROMPTS[1], max_new_tokens=10,
                        ignore_eos=True, temperature=0.7)]
        for r in reqs:
            eng.submit(r)
        eng.step()                      # prefill + admit + one iteration
        dp = eng.dps[0]
        spy = Spy(dp)
        for _ in range(3):
            assert dp.decode_step_all(inject_fault=fault) > 0
        dp.drain()
        runs.append((spy.calls, [list(r.output_tokens) for r in reqs]))
        eng.close()
    (clean, clean_toks), (faulted, fault_toks) = runs
    assert len(faulted) == 2 * len(clean) == 6
    for i, (b, n) in enumerate(clean):
        for b2, n2 in faulted[2 * i:2 * i + 2]:
            np.testing.assert_array_equal(b2, b)
            np.testing.assert_array_equal(n2, n)
    assert fault_toks == clean_toks


def test_temperature_serving_with_random_heads(ref):
    """At temperature 0.7 random heads do get drafts accepted (the
    rejection rule on near-uniform p and q), so residual and bonus draws
    both run; every request finishes with its budget of tokens."""
    _, _, _, tcfg, tparams = ref
    eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=1,
                          max_batch=3, mtp_k=2, seed=3)
    spy = Spy(eng.dps[0])
    out = _serve(eng, Request, n=12, temperature=0.7)
    eng.close()
    assert all(len(t) == 12 and all(0 <= x < tcfg.vocab_size for x in t)
               for t in out)
    n_acc = np.concatenate([c[1] for c in spy.calls])
    assert (n_acc > 0).any() and (n_acc < 2).any()
