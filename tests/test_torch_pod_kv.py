"""The port's ``DPGroup`` prefix-KV and pod-pooled paths against the
reference ``DPGroup``, on real model backends (smoke configurations,
float32, the same weights).

Each scenario runs once per package: local hits, cross-DP (pod
directory) hits, the preference for a longer local hit, a cancelled
remote-seeded chunked prefill that releases its pin once, and a
remote-seeded chunked prefill whose first chunk the cache skips. The
two runs must agree on every count (``prefix_hit_tokens``, remote hits,
pins acquired and released, ``pooled_hit_rate``), on the greedy tokens,
and on the logits within 1e-4; within the port, a seeded prefill's
logits equal a cold group's bit for bit."""
import types

import numpy as np
import pytest

from torch_parity import reference, rel_err

BS = 16
CONFIGS = ["deepseek-v3", "internlm2"]


def _side(name: str, config: str):
    """The classes and a backend factory of one package."""
    jcfg, jmodel, jparams, tcfg, tparams = reference("float32",
                                                     config=config)
    if name == "jax":
        from repro.serving import dp_group, kv_cache, request, scheduler
        from repro.serving.backend import JAXBackend

        def backend():
            return JAXBackend(jmodel, jparams, max_len=256)
    else:
        from repro_torch.models.transformer import Model
        from repro_torch.serving import dp_group, kv_cache, request, scheduler
        from repro_torch.serving.backend import TorchBackend
        model = Model(tcfg)

        def backend():
            return TorchBackend(model, tparams, max_len=256, device="cpu")
    return types.SimpleNamespace(
        backend=backend, DPGroup=dp_group.DPGroup,
        Pod=kv_cache.PodKVDirectory, Request=request.Request,
        ChunkWork=scheduler.ChunkWork)


def _dp(s, dp_id, pod=None):
    return s.DPGroup(dp_id, s.backend(), max_batch=2, max_len=256,
                     pod_directory=pod)


def _refs(dp):
    return [n.ref for n in dp.prefix_cache._nodes.values()]


def _greedy(dp, req, cache, logits, n: int = 4):
    """Admit a prefilled request and decode ``n`` greedy tokens."""
    req.max_new_tokens = n
    req.ignore_eos = True
    dp.admit(req, cache, logits)
    while dp.active:
        dp.decode_step_all()
    dp.drain()
    return list(req.output_tokens)


def _remote_hit(s):
    """dp1 is cold, dp0 published the prefix: dp1 seeds over the pod."""
    pod = s.Pod(block_size=BS)
    dp0, dp1, cold = _dp(s, 0, pod), _dp(s, 1, pod), _dp(s, 9)
    try:
        toks = list(np.arange(2, 102) % 60)
        dp0.run_prefill(s.Request(prompt_tokens=list(toks)))
        q = toks + [7] * 9
        r = s.Request(prompt_tokens=list(q))
        cache, logits = dp1.run_prefill(r)
        _, want = cold.run_prefill(s.Request(prompt_tokens=list(q)))
        out = dict(hits=(dp1.n_remote_hits, dp1.remote_hit_blocks,
                         r.prefix_hit_tokens),
                   pins=(pod.n_remote_acquires, pod.n_releases),
                   owner_refs=max(_refs(dp0)),
                   rates=(dp1.pooled_hit_rate, dp1.prefix_cache.hit_rate),
                   logits=logits, cold_logits=want,
                   tokens=_greedy(dp1, r, cache, logits))
    finally:
        for d in (dp0, dp1, cold):
            d.close()
    return out


def _local_preferred(s):
    """The local tree holds the longer prefix: no pod acquire."""
    pod = s.Pod(block_size=BS)
    dp0, dp1 = _dp(s, 0, pod), _dp(s, 1, pod)
    try:
        toks = list(np.arange(2, 102) % 60)
        dp0.run_prefill(s.Request(prompt_tokens=toks[:50]))   # 3 blocks
        warm = s.Request(prompt_tokens=list(toks))              # 6 blocks
        dp1.run_prefill(warm)
        hits0 = dp1.n_remote_hits
        r = s.Request(prompt_tokens=toks + [7] * 9)
        cache, logits = dp1.run_prefill(r)
        out = dict(hits=(hits0, dp1.n_remote_hits, warm.prefix_hit_tokens,
                         r.prefix_hit_tokens),
                   pins=(pod.n_remote_acquires, pod.n_releases),
                   rates=(dp0.pooled_hit_rate, dp1.pooled_hit_rate),
                   logits=logits, tokens=_greedy(dp1, r, cache, logits))
    finally:
        dp0.close()
        dp1.close()
    return out


def _cancel(s):
    """A remote-seeded chunked prefill cancelled after its skipped first
    chunk releases the owner's blocks exactly once."""
    pod = s.Pod(block_size=BS)
    dp0, dp1 = _dp(s, 0, pod), _dp(s, 1, pod)
    try:
        base = list(np.arange(2, 98) % 60)       # 6 blocks on dp0
        dp0.run_prefill_chunk(s.ChunkWork(
            s.Request(prompt_tokens=list(base)), 0, len(base)))
        req = s.Request(prompt_tokens=base + [7] * 64)
        skipped = dp1.run_prefill_chunk(s.ChunkWork(req, 0, 64))
        during = (req.prefill_pos, dp1.n_remote_hits,
                  req.req_id in dp1._chunk_pins, max(_refs(dp0)),
                  dp1.partial_prefill_cache(req) is not None)
        dp1.drop_partial_prefill(req)
        after = (req.req_id in dp1._chunk_pins, max(_refs(dp0)),
                 pod.n_remote_acquires, pod.n_releases)
        dp1.drop_partial_prefill(req)            # idempotent
        out = dict(skipped=skipped is None, during=during, after=after,
                   again=pod.n_releases,
                   allocator=dp1.allocator.holds(req.req_id))
    finally:
        dp0.close()
        dp1.close()
    return out


def _skip_then_complete(s):
    """The first chunk is covered by the pod: skipped, then the suffix
    chunk completes the prompt; the pin is released, the logits equal a
    cold group's."""
    pod = s.Pod(block_size=BS)
    dp0, dp1, cold = _dp(s, 0, pod), _dp(s, 1, pod), _dp(s, 9)
    try:
        base = list(np.arange(2, 98) % 60)
        dp0.run_prefill_chunk(s.ChunkWork(
            s.Request(prompt_tokens=list(base)), 0, len(base)))
        req = s.Request(prompt_tokens=base + [7] * 32)
        skipped = dp1.run_prefill_chunk(s.ChunkWork(req, 0, 64)) is None
        pos = req.prefill_pos
        cache, logits = dp1.run_prefill_chunk(s.ChunkWork(req, 96, 32))
        _, want = cold.run_prefill(
            s.Request(prompt_tokens=list(req.prompt_tokens)))
        out = dict(skipped=skipped, pos=pos,
                   hits=(dp1.n_remote_hits, req.prefix_hit_tokens),
                   pins=(pod.n_remote_acquires, pod.n_releases),
                   owner_refs=max(_refs(dp0)), logits=logits,
                   cold_logits=want, tokens=_greedy(dp1, req, cache, logits))
    finally:
        for d in (dp0, dp1, cold):
            d.close()
    return out


def _local_chunked(s):
    """One group: a chunked prompt, then a second sharing its first 4
    blocks: the first chunk (32 tokens) is skipped off the local hit and
    the suffix runs in two chunks; locks drain."""
    dp = _dp(s, 0)
    try:
        base = list(np.arange(3, 70) % 50)       # 67 tokens, 4 blocks
        r0 = s.Request(prompt_tokens=list(base))
        for st in range(0, 67, 32):
            out0 = dp.run_prefill_chunk(s.ChunkWork(r0, st, 32))
        req = s.Request(prompt_tokens=base + [5] * 30)
        skipped = dp.run_prefill_chunk(s.ChunkWork(req, 0, 32)) is None
        pos = req.prefill_pos
        dp.run_prefill_chunk(s.ChunkWork(req, 64, 32))
        cache, logits = dp.run_prefill_chunk(s.ChunkWork(req, 96, 32))
        out = dict(first=out0 is not None, skipped=skipped, pos=pos,
                   hit=req.prefix_hit_tokens, refs=max(_refs(dp)),
                   rate=dp.pooled_hit_rate, logits=logits,
                   tokens=_greedy(dp, req, cache, logits))
    finally:
        dp.close()
    return out


SCENARIOS = {"remote_hit": _remote_hit, "local_preferred": _local_preferred,
             "cancel": _cancel, "skip_then_complete": _skip_then_complete,
             "local_chunked": _local_chunked}


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_dp_group_prefix_kv_matches_reference(scenario, config):
    got = SCENARIOS[scenario](_side("torch", config))
    want = SCENARIOS[scenario](_side("jax", config))
    assert set(got) == set(want)
    for k in got:
        if "logits" in k:
            assert rel_err(got[k], want[k]) < 1e-4, k
            assert int(np.argmax(got[k])) == int(np.argmax(want[k])), k
        else:
            assert got[k] == want[k], (k, got[k], want[k])
    # within the port a seeded prefill is the cold one, bit for bit
    if "cold_logits" in got:
        np.testing.assert_array_equal(got["logits"], got["cold_logits"])
    expected = {
        "remote_hit": lambda o: o["hits"] == (1, 6, 96)
        and o["pins"] == (1, 1) and o["owner_refs"] == 0
        and o["rates"][0] > 0.0 and o["rates"][1] == 0.0,
        "local_preferred": lambda o: o["hits"][1] == o["hits"][0]
        and o["hits"][3] == 96 and o["pins"][0] == o["pins"][1],
        "cancel": lambda o: o["skipped"] and o["during"][:3] == (96, 1, True)
        and o["during"][3] > 0 and o["during"][4]
        and o["after"] == (False, 0, 1, 1) and o["again"] == 1
        and not o["allocator"],
        "skip_then_complete": lambda o: o["skipped"] and o["pos"] == 96
        and o["hits"] == (1, 96) and o["pins"] == (1, 1)
        and o["owner_refs"] == 0,
        "local_chunked": lambda o: o["first"] and o["skipped"]
        and o["pos"] == 64 and o["hit"] == 64 and o["refs"] == 0,
    }
    assert expected[scenario](got), got


def test_dp_group_without_prefix_kv_keeps_statistics_only():
    """A backend without the prefix-KV contract (the buffering default)
    stores no payloads and joins no pod directory."""
    from repro_torch.serving.backend import ExecutionBackend
    from repro_torch.serving.dp_group import DPGroup
    from repro_torch.serving.kv_cache import PodKVDirectory

    class Plain(ExecutionBackend):
        vocab_size = 8
        mtp_k = 0

        def init_cache(self, max_batch, max_len):
            return {}

        def prefill(self, tokens):
            return {}, np.zeros(8, np.float32)

        def write_slot(self, cache, cache1, slot):
            return cache

        def decode(self, cache, tokens, positions):
            raise NotImplementedError

        def decode_sample(self, *a, **kw):
            raise NotImplementedError

    pod = PodKVDirectory(block_size=BS)
    dp = DPGroup(0, Plain(), max_batch=1, max_len=256, pod_directory=pod)
    try:
        assert not dp._prefix_kv and dp.pod_dir is None and len(pod) == 0
        from repro_torch.serving.request import Request
        toks = list(range(2, 40))
        dp.run_prefill(Request(prompt_tokens=list(toks)))
        r = Request(prompt_tokens=list(toks))
        dp.run_prefill(r)
        assert r.prefix_hit_tokens == 0 and dp.prefix_cache.n_cached_blocks
    finally:
        dp.close()
