"""The port's disaggregated Prefill-Decode (``repro_torch.core``) against
the reference's ``DisaggregatedPD`` and against the port's colocated
engine, on the smoke configurations in float32 with the same weights.

Mirrors the reference's end-to-end, colocated-equality, chunk-streaming
and per-pair-fabric tests, and adds the pod-pooled prefix cache
(``kv_pool``): sessions sharing a system prompt hit locally, across DP
groups and across TEs, skip covered chunks, and the port must make the
reference's TE choices, hits and greedy tokens; every pin is released
once; the KV the decode side admits is the prefill side's, bit for bit;
MTP runs on the decode side only."""
import pytest
import torch

from repro.core import DisaggregatedPD as JaxPD
from repro.serving.request import Request as JaxRequest
from repro_torch.core import DisaggregatedPD
from repro_torch.serving.flowserve import FlowServeEngine
from repro_torch.serving.request import Request
from repro_torch.xccl.pd_transfer import _leaves, slice_kv_chunk
from repro_torch.xccl.topology import PodTopology
from torch_parity import auto_ctx, reference

#: a 64-byte system prompt (with BOS 65 tokens: four full KV blocks)
SYSTEM = "System: you are the SuperPod's helper; answer briefly, kindly..."
#: waves of one session-heavy run: a first turn, then three sessions and
#: a long unrelated prompt together, then a follow-up turn
WAVES = [[SYSTEM + " User: what is MLA?"],
         [SYSTEM + " User: what is EPLB?", SYSTEM + " User: what is MTP?",
          SYSTEM + " User: and the UB plane?",
          "A long request with no shared prefix at all: it runs for more "
          "than a hundred bytes, so it prefills in several chunks."],
         [SYSTEM + " User: what is MLA? Assistant: latent attention. "
          "User: and then?", "Another distinct prompt"]]


def _pd(side, config, **kw):
    jcfg, _, jparams, tcfg, tparams = reference("float32", config=config)
    kw = {"n_prefill_te": 2, "n_decode_te": 1, "dp_per_te": 2,
          "max_batch": 2, "max_len": 128, **kw}
    if side == "jax":
        return JaxPD(jcfg, jparams, ctx=auto_ctx(), **kw), JaxRequest
    return DisaggregatedPD(tcfg, tparams, device="cpu", **kw), Request


def _serve_waves(pd, request_cls, waves, n_new: int):
    """Serve each wave to completion before the next is submitted."""
    reqs = []
    for wave in waves:
        rs = [request_cls(prompt=p, max_new_tokens=n_new, ignore_eos=True)
              for p in wave]
        n0 = len(pd.finished)
        for r in rs:
            pd.submit(r)
        while len(pd.finished) < n0 + len(rs):
            pd.step()
        reqs += rs
    for te in pd.decode_tes:
        for d in te.dps:
            d.drain()
    return reqs


def _summary(pd, reqs):
    return dict(
        reqs=[(r.prefill_te, r.decode_te, r.prefix_hit_tokens,
               r.n_prefill_chunks, list(r.output_tokens)) for r in reqs],
        remote=[(d.dp_id, d.n_remote_hits, d.remote_hit_blocks,
                 d.prefix_cache.hit_blocks)
                for te in pd.prefill_tes for d in te.dps],
        flows={k: (f.fabric, f.chunks_streamed, f.bytes_moved,
                   len(f.streams)) for k, f in sorted(pd.distflow.items())},
        pins=(None if pd.pod_dir is None else
              (pd.pod_dir.n_remote_acquires, pd.pod_dir.n_releases)))


def test_pd_disagg_end_to_end_equals_reference():
    prompts = [["hello", "world", "foo bar", "a longer one here"]]
    got_pd, req = _pd("torch", "internlm2")
    got = _summary(got_pd, _serve_waves(got_pd, req, prompts, 5))
    got_pd.close()
    want_pd, req = _pd("jax", "internlm2")
    want = _summary(want_pd, _serve_waves(want_pd, req, prompts, 5))
    want_pd.close()
    assert got == want
    assert all(len(r[4]) == 5 for r in got["reqs"])
    assert sum(f[2] for f in got["flows"].values()) > 0


@pytest.mark.parametrize("chunk_tokens", [None, 8])
@pytest.mark.parametrize("config", ["internlm2", "deepseek-v3"])
def test_pd_disagg_matches_colocated(config, chunk_tokens):
    """The same greedy tokens as the port's colocated engine; with
    8-token chunks the KV ships chunk by chunk and no stream stays
    open."""
    *_, tcfg, tparams = reference("float32", config=config)
    prompt = "same tokens please, in a few chunks"
    eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=1,
                          max_batch=2, max_len=128, chunk_tokens=chunk_tokens)
    want = eng.generate([prompt], max_new_tokens=6)
    eng.close()
    pd = DisaggregatedPD(tcfg, tparams, device="cpu", n_prefill_te=1,
                         n_decode_te=1, dp_per_te=1, max_batch=2,
                         max_len=128, chunk_tokens=chunk_tokens)
    done = pd.run_until_done([Request(prompt=prompt, max_new_tokens=6)])
    assert pd.tokenizer.decode(done[0].output_tokens) == want[0]
    streamed = sum(f.chunks_streamed for f in pd.distflow.values())
    assert streamed == (1 if chunk_tokens is None else
                        -(-done[0].prompt_len // chunk_tokens))
    assert sum(f.bytes_moved for f in pd.distflow.values()) > 0
    assert not any(f.streams for f in pd.distflow.values())
    pd.close()


def test_pd_disagg_streams_chunks_like_reference():
    prompts = [["same tokens please", "stream these chunks to decode"]]
    got_pd, req = _pd("torch", "internlm2", chunk_tokens=8)
    got = _summary(got_pd, _serve_waves(got_pd, req, prompts, 6))
    got_pd.close()
    want_pd, req = _pd("jax", "internlm2", chunk_tokens=8)
    want = _summary(want_pd, _serve_waves(want_pd, req, prompts, 6))
    want_pd.close()
    assert got == want
    assert sum(f[1] for f in got["flows"].values()) > 2


def test_pd_disagg_topology_selects_per_pair_fabric():
    """Two pods: the pod-1 prefill TE reaches the pod-0 decode TE over
    RoCE, the pod-0 one over UB, as in the reference."""
    kw = dict(dp_per_te=1, topology=PodTopology.two_pod(),
              pod_of_prefill_te=[0, 1], pod_of_decode_te=[0])
    prompts = [["hello", "cross pod"]]
    got_pd, req = _pd("torch", "internlm2", **kw)
    assert got_pd.distflow["p0-d0"].fabric == "ub"
    assert got_pd.distflow["p1-d0"].fabric == "roce"
    assert [t.fabric for t in got_pd.prefill_tes] == ["ub", "roce"]
    got = _summary(got_pd, _serve_waves(got_pd, req, prompts, 4))
    got_pd.close()
    from repro.xccl.topology import PodTopology as JaxTopology
    want_pd, req = _pd("jax", "internlm2", **dict(
        kw, topology=JaxTopology.two_pod()))
    want = _summary(want_pd, _serve_waves(want_pd, req, prompts, 4))
    want_pd.close()
    assert got == want


def test_pd_disagg_topology_excludes_flat_fabric_list():
    *_, tcfg, tparams = reference("float32", config="internlm2")
    with pytest.raises(ValueError, match="not both"):
        DisaggregatedPD(tcfg, tparams, device="cpu", n_prefill_te=1,
                        n_decode_te=1, dp_per_te=1,
                        topology=PodTopology.two_pod(),
                        prefill_fabrics=["ub"])
    with pytest.raises(ValueError, match="2 entries for 1 TEs"):
        DisaggregatedPD(tcfg, tparams, device="cpu", n_prefill_te=1,
                        n_decode_te=1, dp_per_te=1,
                        topology=PodTopology.two_pod(),
                        pod_of_prefill_te=[0, 1])


def _kv_pool_run(side):
    pd, req = _pd(side, "deepseek-v3", max_batch=4, max_len=256,
                  chunk_tokens=32, kv_pool=True)
    out = _summary(pd, _serve_waves(pd, req, WAVES, 8))
    pd.close()
    return out


def test_pd_kv_pool_matches_reference():
    """Sessions sharing a system prompt: the port makes the reference's
    TE choices and hits (local, across DP groups, across TEs), skips the
    same chunks, streams the same bytes and gives the same tokens."""
    got = _kv_pool_run("torch")
    assert got == _kv_pool_run("jax")
    hits = [r[2] for r in got["reqs"]]
    assert sum(h > 0 for h in hits) >= 4 and max(hits) >= 64
    assert sum(d[1] for d in got["remote"]) >= 1          # remote hits
    assert sum(d[3] for d in got["remote"]) > 0           # local hits
    assert len({r[0] for r in got["reqs"]}) == 2          # both TEs
    assert got["pins"][0] == got["pins"][1] >= 1
    assert not any(f[3] for f in got["flows"].values())


def test_pd_admitted_kv_is_the_prefill_sides():
    """With chunk skips and streaming, the KV each decode group admits
    equals ``slice_kv_chunk(cache1, 0, L)`` of the prefill group's final
    cache, bit for bit, and the watermark leaves nothing behind."""
    *_, tcfg, tparams = reference("float32", config="deepseek-v3")
    pd = DisaggregatedPD(tcfg, tparams, device="cpu", n_prefill_te=2,
                         n_decode_te=1, dp_per_te=2, max_batch=4,
                         max_len=256, chunk_tokens=32, kv_pool=True)
    finals, admitted, skips = {}, {}, []
    for te in pd.prefill_tes:
        for dp in te.dps:
            def run(work, _real=dp.run_prefill_chunk):
                out = _real(work)
                if out is not None:
                    finals[work.req.req_id] = slice_kv_chunk(
                        out[0], 0, work.req.prompt_len)
                elif work.is_first and work.req.prefill_pos > work.end:
                    skips.append(work.req.req_id)
                return out
            dp.run_prefill_chunk = run
    for dp in pd.decode_tes[0].dps:
        def admit(req, kv, logits, _real=dp.admit):
            admitted[req.req_id] = kv
            return _real(req, kv, logits)
        dp.admit = admit
    reqs = _serve_waves(pd, Request, WAVES, 4)
    assert skips and set(admitted) == set(finals) == {r.req_id for r in reqs}
    for rid, kv in admitted.items():
        a, b = _leaves(kv), _leaves(finals[rid])
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
    assert not pd._shipped and not pd._pending_admit
    assert pd.pod_dir.n_releases == pd.pod_dir.n_remote_acquires >= 1
    assert all(not d._chunk_pins and not d._chunk_locks
               for te in pd.prefill_tes for d in te.dps)
    pd.close()


def test_pd_mtp_runs_on_the_decode_side_only():
    """``mtp_k`` gives decode groups a draft head and leaves prefill
    groups without one; greedy tokens equal the plain PD's (MTP is
    lossless)."""
    *_, tcfg, tparams = reference("float32", config="deepseek-v3")
    out = {}
    for k in (0, 2):
        pd = DisaggregatedPD(tcfg, tparams, device="cpu", n_prefill_te=1,
                             n_decode_te=1, dp_per_te=1, max_batch=2,
                             max_len=128, chunk_tokens=16, mtp_k=k)
        assert all(d.mtp_k == 0 for d in pd.prefill_tes[0].dps)
        assert all(d.mtp_k == k for d in pd.decode_tes[0].dps)
        reqs = _serve_waves(pd, Request, [["draft on decode", "only"]], 6)
        out[k] = [list(r.output_tokens) for r in reqs]
        pd.close()
    assert out[0] == out[2]
    assert all(len(t) == 6 for t in out[0])


def test_pd_bulk_path_for_a_backend_without_chunked_prefill(monkeypatch):
    """A backend that cannot prefill incrementally keeps the bulk path:
    one registered transfer per request, triggered at admission."""
    from repro_torch.serving.backend import TorchBackend
    monkeypatch.setattr(TorchBackend, "supports_chunked_prefill", False)
    *_, tcfg, tparams = reference("float32", config="internlm2")
    pd = DisaggregatedPD(tcfg, tparams, device="cpu", n_prefill_te=1,
                         n_decode_te=1, dp_per_te=1, max_batch=2,
                         max_len=128, chunk_tokens=8)
    reqs = _serve_waves(pd, Request, [["bulk transfer, chunked schedule"]],
                        4)
    flow = pd.distflow["p0-d0"]
    assert len(reqs[0].output_tokens) == 4
    assert flow.chunks_streamed == 0 and flow.bytes_moved > 0
    assert not flow.tasks and not flow.completion_queue
    pd.close()
