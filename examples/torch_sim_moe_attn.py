"""MoE-Attention disaggregation walkthrough (§5.2) in the port's SuperPod
simulator: the same serving control plane, two deployments. Every
figure printed is a MODELED CloudMatrix384 figure, not a measurement of
any card; the lines equal ``examples/sim_moe_attn.py``'s.

``deployment="colocated"`` prices every decode DP group as a monolithic
die running attention + expert FFN serially per layer (the §4.4
ping-pong chain). ``deployment="moe_attn"`` splits the pod into an
attention pool and a shared expert pool bridged by §3.3 A2E/E2A
trampolines, and prices each iteration through the Fig. 19 DP-domain
pipeline — the closed form that ``DomainPipeline.schedule()``
cross-validates.

The walkthrough shows the three effects that make the mode worth
simulating:

  1. the colocated-vs-disagg crossover: disaggregation wins at large
     batch-per-die (expert compute + trampolines hide under attention)
     and loses at small batch (per-microbatch trampoline latency and
     expert-stage launches are exposed — pipeline bubbles),
  2. pool-aware faults: a straggling or dead EXPERT die degrades every
     attention DP that dispatches to it, while an attention-die death
     stays a one-DP failover,
  3. per-layer EPLB: hot experts inflate the expert stage of exactly
     their layers; balancing claws the inflation back in both modes.

    PYTHONPATH=src python examples/torch_sim_moe_attn.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config
from repro_torch.core.transformerless import plan_partition
from repro_torch.sim import (FaultPlan, SimConfig, SuperPodCostModel,
                             SuperPodSim, WorkloadConfig)


def show(tag: str, rep) -> None:
    s = rep.summary
    extra = ""
    if s["deployment"] == "moe_attn":
        extra = (f"  expert_util={s['expert_pool_util']:.2f}"
                 f"  bubble={s['pipeline_bubble_fraction']:.2f}")
    print(f"{tag:>26}: tpot={s['tpot_mean_s'] * 1e3:6.1f}ms  "
          f"{s['throughput_tok_s_per_die']:6.1f} tok/s/die  "
          f"finished={s['n_finished']}/{s['n_requests']}  "
          f"failovers={s['n_failovers']}{extra}")


def main() -> None:
    cfg = get_config("deepseek-v3-671b")
    plan = plan_partition(cfg, 768)
    cost = SuperPodCostModel(cfg, plan)
    print(f"partition plan: {plan.n_attention} attention + "
          f"{plan.n_expert} expert dies, {plan.n_dp_domains} DP domains "
          f"x {plan.dp_groups_per_domain} groups (the paper's 288/480)")

    # -- 1. the crossover, straight from the cost model ----------------
    print("\ncolocated vs disaggregated decode iteration:")
    for b in (4, 16, 32, 96):
        t_col = cost.decode_iter_time(b, mean_context=1024)
        c = cost.moe_attn_decode_iter_time(b, mean_context=1024)
        who = "disagg" if c.t_iter < t_col else "colocated"
        print(f"   bpd {b:>3}: colocated {t_col * 1e3:5.1f}ms  "
              f"disagg {c.t_iter * 1e3:5.1f}ms  "
              f"bubble={c.bubble_frac:.2f}  -> {who} wins")

    # -- 2. end-to-end serving runs, both deployments ------------------
    wl = WorkloadConfig(arrival_rate=80.0, duration_s=1.0, seed=11)
    col = SimConfig(n_sim_dps=8, eplb_interval_s=0.5)
    dis = SimConfig(n_sim_dps=8, eplb_interval_s=0.5,
                    deployment="moe_attn")
    print()
    show("colocated pod", SuperPodSim(col, wl).run())
    show("moe_attn pod", SuperPodSim(dis, wl).run())

    # -- 3. pool-aware faults ------------------------------------------
    # an expert-pool die throttles 0.3s in: EVERY attention DP's MoE
    # stage stretches (the EP all-to-all has no way around it)
    show("expert-die straggler (4x)", SuperPodSim(
        dis, wl, FaultPlan(straggler_dp=2, straggler_at=0.3,
                           straggler_slowdown=4.0,
                           straggler_pool="expert")).run())
    # a dead expert die: survivors absorb its experts (capacity loss,
    # no failovers); a dead ATTENTION die stays a one-DP failover
    show("dead expert die", SuperPodSim(
        dis, wl, FaultPlan(dead_dp=1, dead_at=0.3,
                           dead_pool="expert")).run())
    show("dead attention DP", SuperPodSim(
        dis, wl, FaultPlan(dead_dp=1, dead_at=0.3)).run())

    # -- 4. hot experts + per-layer EPLB in the disagg pipeline --------
    skew = FaultPlan(expert_skew=0.8)
    off = SimConfig(n_sim_dps=8, eplb_enabled=False,
                    deployment="moe_attn")
    show("hot experts, no EPLB", SuperPodSim(off, wl, skew).run())
    show("hot experts + EPLB", SuperPodSim(dis, wl, skew).run())


if __name__ == "__main__":
    main()
