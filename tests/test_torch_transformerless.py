"""The port's Transformerless units, partition planner, DP-domain
pipeline model and dataflow runtime (``repro_torch.core``) against the
reference's: pure Python on both sides, so every number is compared
exactly.

* ``split_model`` and ``plan_partition`` for every configuration in the
  registry (full width and smoke, at several die counts), with the
  paper's 768-die DeepSeek-V3 split pinned: 288 expert dies and 480
  attention dies, 3 DP domains × 160 groups, 2 microbatches.
* ``DomainPipeline.schedule`` and ``steady_state`` on the paper's
  Ascend 910C stage times (``paper_stage_times``) and on seeded random
  per-layer ``StageTimes``: iteration time, busy shares and the timeline
  equal to the last bit.
* The dataflow graph of the reference's no-global-barrier test: the
  same firing count and sink payloads, tags included.
"""
import dataclasses

import numpy as np
import pytest

from repro import core as jcore
from repro.configs import get_config as jax_get_config
from repro.configs.registry import ALL_ARCHS as JAX_ARCHS
from repro_torch import core as tcore
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.registry import ALL_ARCHS

DIES = (64, 768, 1024)


def test_registry_is_the_references():
    assert list(ALL_ARCHS) == list(JAX_ARCHS)


@pytest.mark.parametrize("arch", [a + s for a in ALL_ARCHS
                                  for s in ("", "-smoke")])
def test_split_and_plan_match_reference(arch):
    jcfg, tcfg = jax_get_config(arch), torch_get_config(arch)
    assert ([dataclasses.asdict(u) for u in tcore.split_model(tcfg)]
            == [dataclasses.asdict(u) for u in jcore.split_model(jcfg)])
    assert ([u.stateless for u in tcore.split_model(tcfg)]
            == [u.stateless for u in jcore.split_model(jcfg)])
    for dies in DIES:
        t, j = tcore.plan_partition(tcfg, dies), jcore.plan_partition(
            jcfg, dies)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.total == j.total == dies


def test_deepseek_v3_plan_is_the_papers_split():
    plan = tcore.plan_partition(torch_get_config("deepseek-v3-671b"), 768)
    assert (plan.n_expert, plan.n_attention) == (288, 480)
    assert (plan.n_dp_domains, plan.dp_groups_per_domain) == (3, 160)
    assert plan.microbatches == 2


def _reports_equal(t, j):
    assert t.iteration_time == j.iteration_time
    assert t.expert_busy == j.expert_busy
    assert t.attention_busy == j.attention_busy
    assert t.timeline == j.timeline


def _times(pkg, rng, n_layers):
    return [pkg.StageTimes(*(float(v) for v in rng.uniform(1e-5, 1e-3, 4)))
            for _ in range(n_layers)]


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("dies", [768, 64])
def test_domain_pipeline_matches_reference(arch, dies):
    jcfg, tcfg = jax_get_config(arch), torch_get_config(arch)
    jplan, tplan = (jcore.plan_partition(jcfg, dies),
                    tcore.plan_partition(tcfg, dies))
    jt, tt = jcore.paper_stage_times(jcfg), tcore.paper_stage_times(tcfg)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    n = jcfg.num_layers
    cases = [(tt, jt), (tt.scaled(moe=1.7, attn=0.9),
                        jt.scaled(moe=1.7, attn=0.9))]
    for seed in range(3):
        cases.append((_times(tcore, np.random.default_rng(seed), n),
                      _times(jcore, np.random.default_rng(seed), n)))
    for t_times, j_times in cases:
        tp = tcore.DomainPipeline(tplan, t_times, n)
        jp = jcore.DomainPipeline(jplan, j_times, n)
        _reports_equal(tp.schedule(), jp.schedule())
        _reports_equal(tp.steady_state(), jp.steady_state())


def _barrier_graph(pkg):
    g = pkg.DataflowGraph()
    calls = []
    g.add(pkg.Node("a1", lambda x: calls.append("a1") or x + 1))
    g.add(pkg.Node("a2", lambda x: calls.append("a2") or x * 2))
    g.add(pkg.Node("b1", lambda x: calls.append("b1") or x - 1))
    g.connect("a1", "a2")
    g.mark_sink("a2")
    g.mark_sink("b1")
    for i in range(3):
        g.inject("a1", pkg.Packet(pkg.Tag(req_id=1, iteration=i), i))
        g.inject("b1", pkg.Packet(pkg.Tag(req_id=2, iteration=i), 10 * i))
    return g, calls


def test_dataflow_no_global_barrier_matches_reference():
    (tg, tcalls), (jg, jcalls) = _barrier_graph(tcore), _barrier_graph(jcore)
    assert tg.run() == jg.run() == 9
    assert tcalls == jcalls
    for name in ("a2", "b1"):
        assert ([(p.tag.req_id, p.tag.iteration, p.payload)
                 for p in tg.sinks[name]]
                == [(p.tag.req_id, p.tag.iteration, p.payload)
                    for p in jg.sinks[name]])
    assert [p.payload for p in tg.sinks["a2"]] == [2, 4, 6]
    assert [p.payload for p in tg.sinks["b1"]] == [-1, 9, 19]


def test_dataflow_join_waits_for_matching_tags():
    """A two-input node fires only on equal tags; a "!"-suffixed node
    advances the iteration, on both sides alike."""
    out = []
    for pkg in (tcore, jcore):
        g = pkg.DataflowGraph()
        g.add(pkg.Node("join!", lambda a, b: a + b, n_inputs=2))
        g.mark_sink("join!")
        g.inject("join!", pkg.Packet(pkg.Tag(1, 0), 1), port=0)
        g.inject("join!", pkg.Packet(pkg.Tag(2, 0), 5), port=1)
        first = g.run()
        g.nodes["join!"].inputs[1].pop()
        g.inject("join!", pkg.Packet(pkg.Tag(1, 0), 2), port=1)
        out.append((first, g.run(),
                    [(p.tag, p.payload) for p in g.sinks["join!"]]))
    (tf, tr, ts), (jf, jr, js) = out
    assert (tf, tr) == (jf, jr) == (0, 1)
    assert [(t.req_id, t.iteration, v) for t, v in ts] \
        == [(t.req_id, t.iteration, v) for t, v in js] == [(1, 1, 3)]
