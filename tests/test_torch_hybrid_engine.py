"""The port's engines serving the recurrent and hybrid families, against
the reference's engines (built on the Auto-axis mesh) with the same
weights, float32.

RecurrentGemma (smoke, with its 2-layer tail) and Mamba-2 (smoke): the
port's ``FlowServeEngine`` gives the reference engine's greedy tokens,
with whole prompts and with 8-token chunks. Neither model can resume a
prefill mid-prompt (a ring window, a recurrent state), so every request
takes the buffering default of ``prefill_chunk``: one ``prefill`` of the
whole prompt, no chunk computed on its own, no radix seeding (a prompt
served twice is prefilled twice). ``DisaggregatedPD`` takes the bulk
path: one registered transfer per request, no KV streamed in chunks,
and the colocated engine's tokens."""
import pytest

from repro.serving.flowserve import FlowServeEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.core import DisaggregatedPD
from repro_torch.models.transformer import Model
from repro_torch.serving import distflow
from repro_torch.serving.backend import TorchBackend
from repro_torch.serving.flowserve import FlowServeEngine
from repro_torch.serving.request import Request
from torch_parity import auto_ctx, reference

#: the 70-byte prompt's bucket (128) is past the smoke ring (64 slots)
PROMPTS = ["hello world", "the quick brown fox jumps",
           "a recurrent state folds every token it is given, pads too, "
           "and moves on", "hello world"]


def _serve(engine, request_cls, n_new=8):
    reqs = [request_cls(prompt=p, max_new_tokens=n_new, ignore_eos=True)
            for p in PROMPTS]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    return [list(r.output_tokens) for r in reqs]


@pytest.fixture
def counted(monkeypatch):
    """Counts of the backend's monolithic prefills, the model's chunk
    programs and the radix seeds while a test runs."""
    n = {"prefill": 0, "prefill_chunk": 0, "seed": 0}

    def spy(name, owner, attr):
        real = getattr(owner, attr)

        def wrapped(*a, **kw):
            n[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(owner, attr, wrapped)
    spy("prefill", TorchBackend, "prefill")
    spy("prefill_chunk", Model, "prefill_chunk")
    spy("seed", TorchBackend, "seed_prefill_cache")
    return n


@pytest.mark.parametrize("chunk_tokens", [None, 8])
@pytest.mark.parametrize("config", ["recurrentgemma", "mamba2"])
def test_engine_greedy_tokens_identical_to_reference(config, chunk_tokens,
                                                     counted):
    jcfg, _, jparams, tcfg, tparams = reference("float32", config=config)
    jeng = JaxEngine(jcfg, jparams, ctx=auto_ctx(), n_dp_groups=2,
                     max_batch=2, chunk_tokens=chunk_tokens)
    want = _serve(jeng, JaxRequest)
    jeng.close()
    teng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=2,
                           max_batch=2, chunk_tokens=chunk_tokens)
    assert not any(d.backend.supports_chunked_prefill for d in teng.dps)
    got = _serve(teng, Request)
    teng.close()
    assert got == want
    assert all(len(t) == 8 for t in got)
    assert counted == {"prefill": len(PROMPTS), "prefill_chunk": 0,
                       "seed": 0}


@pytest.mark.parametrize("config", ["recurrentgemma", "mamba2"])
def test_pd_takes_the_bulk_path(config, counted, monkeypatch):
    _, _, _, tcfg, tparams = reference("float32", config=config)
    flows = {"register": 0, "open_stream": 0, "stream_chunk": 0}
    for name in flows:
        real = getattr(distflow.DistFlowInstance, name)

        def wrapped(self, *a, _real=real, _name=name, **kw):
            flows[_name] += 1
            return _real(self, *a, **kw)
        monkeypatch.setattr(distflow.DistFlowInstance, name, wrapped)
    pd = DisaggregatedPD(tcfg, tparams, n_prefill_te=2, n_decode_te=1,
                         dp_per_te=2, max_batch=2, device="cpu",
                         chunk_tokens=8, kv_pool=True)
    reqs = [Request(prompt=p, max_new_tokens=8, ignore_eos=True)
            for p in PROMPTS]
    done = pd.run_until_done(reqs)
    pd.close()
    got = [list(r.output_tokens) for r in sorted(done,
                                                 key=lambda r: r.req_id)]
    assert flows == {"register": len(PROMPTS), "open_stream": 0,
                     "stream_chunk": 0}
    assert counted == {"prefill": len(PROMPTS), "prefill_chunk": 0,
                       "seed": 0}
    assert all(r.prefix_hit_tokens == 0 for r in done)
    eng = FlowServeEngine(tcfg, tparams, device="cpu", n_dp_groups=2,
                          max_batch=2)
    want = _serve(eng, Request)
    eng.close()
    assert got == want
    assert all(len(t) == 8 for t in got)
