"""The SuperPod simulator end to end against the reference: seeded runs
of both packages' ``SuperPodSim`` must give the same trace digest and
the same report JSON, byte for byte, over the deployments, faults and
traffic features the simulator models. Also the control-plane pieces it
added to the port (``DPGroup.active_requests`` / ``evict``, a DP group
over ``CostModelBackend`` as the simulator builds one), the workload's
random stream, and the DP groups' output threads.

Each scenario runs at the reference tests' small size (4 simulated DP
groups, EPLB every 0.5 s, 40 requests/s for 0.6 s); the fault times and
factors are small enough that the drain stays short.
"""
import dataclasses
import threading

import pytest

import repro.serving.request as jax_request
import repro.serving.scheduler as jax_scheduler
import repro.sim as jax_sim
import repro_torch.serving.request as torch_request
import repro_torch.serving.scheduler as torch_scheduler
import repro_torch.sim as torch_sim
from repro.configs import get_config as jax_get_config
from repro.core.transformerless import plan_partition as jax_plan
from repro.serving.dp_group import DPGroup as JaxDPGroup
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.transformerless import plan_partition as torch_plan
from repro_torch.serving.dp_group import DPGroup as TorchDPGroup
from torch_parity import write_sim_calibration

ARCH = "deepseek-v3-671b"
SMALL = dict(n_sim_dps=4, eplb_interval_s=0.5)
WL = dict(arrival_rate=40.0, duration_s=0.6, seed=5)

#: name → (SimConfig fields, WorkloadConfig fields, FaultPlan fields,
#: the summary counters the scenario must make non-zero)
SCENARIOS = {
    "colocated": ({}, {}, {}, ("n_reconfigs",)),
    "moe_attn": ({"deployment": "moe_attn"}, {}, {},
                 ("a2e_bytes", "pipeline_bubble_fraction")),
    "attn_faults": ({}, {}, dict(straggler_dp=1, straggler_at=0.1,
                                 straggler_slowdown=1.5, dead_dp=2,
                                 dead_at=0.15), ("n_failovers",)),
    "expert_faults": ({"deployment": "moe_attn"}, {},
                      dict(straggler_dp=1, straggler_at=0.1,
                           straggler_slowdown=1.5, straggler_pool="expert",
                           dead_dp=2, dead_at=0.15, dead_pool="expert"),
                      ("expert_pool_util",)),
    "prefix_pool": ({"kv_pool": True, "kv_link_fifo": True},
                    {"prefix_share": 0.5, "session_migration": 0.3}, {},
                    ("n_prefix_hits", "n_pod_remote_hits",
                     "n_kv_xfers_queued")),
    "prefill_colocated": ({"prefill_colocated": True,
                           "long_context_tes": 1},
                          {"long_context_fraction": 0.1}, {},
                          ("n_contended_decode_iters",
                           "n_long_routed_dedicated")),
    "mtp": ({"mtp_k": 1}, {}, {}, ("n_decode_tokens",)),
    "two_pods": ({"n_pods": 2}, {}, dict(dead_pod_id=1, dead_pod_at=0.2),
                 ("n_cross_pod_kv_xfers", "n_pod_failovers",
                  "n_pod_reroutes")),
    "skew_layer0": ({"eplb_per_layer": False}, {"expert_skew": 0.8}, {},
                    ("n_reconfigs",)),
    "calibrated": ({"calibration": True}, {}, {}, ("n_reconfigs",)),
}


def _run(sim, name, tmp_path):
    sim_kw, wl_kw, fault_kw, _ = SCENARIOS[name]
    sim_kw = dict(sim_kw)
    if sim_kw.pop("calibration", False):
        sim_kw["calibration_paths"] = write_sim_calibration(tmp_path)
    s = sim.SuperPodSim(sim.SimConfig(arch=ARCH, **{**SMALL, **sim_kw}),
                        sim.WorkloadConfig(**{**WL, **wl_kw}),
                        sim.FaultPlan(**fault_kw) if fault_kw else None)
    return s, s.run()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_seeded_report_equals_reference(name, tmp_path):
    ref_sim, ref = _run(jax_sim, name, tmp_path)
    before = set(threading.enumerate())
    sim, rep = _run(torch_sim, name, tmp_path)
    # run() joined every DP group's output thread
    assert set(threading.enumerate()) <= before
    assert rep.trace_hash == ref.trace_hash
    assert rep.to_json(include_requests=True) \
        == ref.to_json(include_requests=True)
    s = rep.summary
    assert s["n_finished"] == s["n_requests"] > 0
    assert (sim.plan.n_expert, sim.plan.n_attention) == (288, 480)
    for key in SCENARIOS[name][3]:
        assert s[key] > 0, key
    if name == "mtp":
        assert s["tokens_per_decode_iter"] > 1.0
    if name == "calibrated":
        assert sim.cost.iter_overhead == ref_sim.cost.iter_overhead \
            == 512.25 * 1e-6
        assert sim.cost.prefill_hit_skip == 0.6036


# ---------------------------------------------------------------------------
# the workload: the same random stream, and greedy throughout
# ---------------------------------------------------------------------------
def _workload_log(sim):
    cfg = sim.WorkloadConfig(arrival_rate=200.0, duration_s=0.5, seed=3,
                             prefix_share=0.5, session_migration=0.3,
                             long_context_fraction=0.1, expert_skew=0.9)
    gen = sim.WorkloadGen(cfg, n_experts=16, n_layers=3)
    log, temps = [], set()
    for t, req in gen.requests():
        log.append((t, req.prompt_tokens, req.max_new_tokens,
                    req.ignore_eos, getattr(req, "migrate", False)))
        temps.add(req.temperature)
        log.append(gen.expert_counts(len(log), 8).tolist())
    gen.set_skew(0.0)
    log.append(gen.expert_counts(5, 2).tolist())
    return log, temps


def test_workload_stream_equal_and_greedy():
    got, got_temps = _workload_log(torch_sim)
    want, want_temps = _workload_log(jax_sim)
    assert got == want
    assert len(got) > 100 and any(x[4] for x in got[::2])
    # the DP group's admit-time sampler (numpy in the port, jax.random in
    # the reference) never draws in the simulator: every request is
    # greedy
    assert got_temps == want_temps == {0.0}


# ---------------------------------------------------------------------------
# the control-plane pieces the simulator added
# ---------------------------------------------------------------------------
def _cost(side):
    if side == "ref":
        cfg = jax_get_config(ARCH)
        return jax_sim.SuperPodCostModel(cfg, jax_plan(cfg, 768))
    cfg = torch_get_config(ARCH)
    return torch_sim.SuperPodCostModel(cfg, torch_plan(cfg, 768))


def _evict_log(side):
    sim = jax_sim if side == "ref" else torch_sim
    group_cls = JaxDPGroup if side == "ref" else TorchDPGroup
    request = jax_request if side == "ref" else torch_request
    dp = group_cls(0, sim.CostModelBackend(0, _cost(side)), max_batch=4,
                   max_len=128, n_kv_blocks=64)
    try:
        reqs = [request.Request(prompt_tokens=list(range(2, 2 + n)),
                                max_new_tokens=20, ignore_eos=True)
                for n in (40, 17, 33)]
        for i, r in enumerate(reqs):
            r.req_id = 100 + i
            dp.admit(r, *dp.run_prefill(r))
        dp.decode_step_all()
        dp.decode_step_all()
        log = [[r.req_id for r in dp.active_requests()],
               dp.allocator.usage, dp.allocator.free_blocks]
        out = dp.evict(1)
        log += [out.req_id, str(out.state), out.slot, out.dp_group,
                out.n_emitted, dp.evict(1), dp.evict(3),
                [r.req_id for r in dp.active_requests()],
                dp.allocator.usage, dp.allocator.free_blocks, dp.active,
                [s.free for s in dp.slots]]
        # the freed slot admits again, and the survivors keep decoding
        dp.admit(out, *dp.run_prefill(out))
        dp.decode_step_all()
        log += [[(r.req_id, r.n_emitted, r.slot)
                 for r in dp.active_requests()], dp.allocator.usage]
        dp.drain()
        return log
    finally:
        dp.close()


def test_dp_group_active_requests_and_evict_equal():
    got, want = _evict_log("port"), _evict_log("ref")
    assert got == want
    assert got[3] == 101 and got[10] == [100, 102]


def _served_tokens(side, mtp_k):
    """A DP group over the cost backend, built as ``SuperPodSim`` builds
    one, serving five prompts (chunked prefill, then decode to the end):
    the tokens, emit counts and the backend's counters."""
    sim = jax_sim if side == "ref" else torch_sim
    group_cls = JaxDPGroup if side == "ref" else TorchDPGroup
    request = jax_request if side == "ref" else torch_request
    sched = jax_scheduler if side == "ref" else torch_scheduler
    dp = group_cls(1, sim.CostModelBackend(1, _cost(side), mtp_k=mtp_k),
                   max_batch=3, max_len=128, n_kv_blocks=64)
    try:
        reqs = [request.Request(prompt_tokens=list(range(3, 3 + n)),
                                max_new_tokens=m, ignore_eos=True)
                for n, m in ((14, 9), (40, 5), (9, 12), (21, 7), (1, 3))]
        waiting = list(reqs)
        for i, r in enumerate(reqs):
            r.req_id = 200 + i
        while waiting or dp.active:
            while waiting and dp.active < dp.max_batch:
                r, out, start = waiting.pop(0), None, 0
                while out is None:               # 16-token chunks
                    n = min(16, len(r.prompt_tokens) - start)
                    out = dp.run_prefill_chunk(sched.ChunkWork(r, start, n))
                    start += n
                dp.admit(r, *out)
            dp.decode_step_all()
        dp.drain()
        b = dp.backend
        return [(r.output_tokens, r.n_emitted, r.state.name)
                for r in reqs], [b.n_prefill_chunks, b.n_decode_steps]
    finally:
        dp.close()


@pytest.mark.parametrize("mtp_k", [0, 1])
def test_dp_group_on_cost_backend_equal(mtp_k):
    got, want = _served_tokens("port", mtp_k), _served_tokens("ref", mtp_k)
    assert got == want
    assert all(len(t) == n for t, n, _ in got[0])
    assert got[1][0] > 5             # chunked through the cost backend


def test_no_thread_left_when_the_constructor_raises(monkeypatch):
    before = set(threading.enumerate())
    with pytest.raises(ValueError, match="prefill_colocated"):
        torch_sim.SuperPodSim(torch_sim.SimConfig(
            arch=ARCH, deployment="moe_attn", prefill_colocated=True,
            **SMALL))
    with pytest.raises(ValueError, match="mtp_k"):
        torch_sim.SuperPodSim(torch_sim.SimConfig(
            arch=ARCH, deployment="moe_attn", mtp_k=1, **SMALL))

    def broken(*a, **k):
        raise RuntimeError("shell failed")

    # after the DP groups (and their threads) exist
    monkeypatch.setattr(torch_sim.engine, "TEShell", broken)
    with pytest.raises(RuntimeError, match="shell failed"):
        torch_sim.SuperPodSim(torch_sim.SimConfig(arch=ARCH, **SMALL))
    assert set(threading.enumerate()) <= before
    # a sim that is never run joins its threads through close()
    monkeypatch.undo()
    sim = torch_sim.SuperPodSim(torch_sim.SimConfig(arch=ARCH, **SMALL))
    assert len(set(threading.enumerate()) - before) == SMALL["n_sim_dps"]
    sim.close()
    sim.close()
    assert set(threading.enumerate()) <= before


def test_package_exports():
    assert sorted(torch_sim.__all__) == sorted(jax_sim.__all__)
    for name in torch_sim.__all__:
        assert getattr(torch_sim, name).__module__.startswith(
            "repro_torch.sim.")
    for f in dataclasses.fields(jax_sim.SimConfig):
        assert getattr(torch_sim.SimConfig(), f.name) \
            == getattr(jax_sim.SimConfig(), f.name), f.name
