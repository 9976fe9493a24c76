"""SuperPod simulator walkthrough on the port: serve DeepSeek-V3 at
384-die scale on the host, then break the pod and watch the control
plane recover.

The simulator runs the port's serving control plane (prefill scheduler,
decode load balancer, TE-shell EPLB, tiered heartbeats) over a modeled
CloudMatrix384 fabric — model execution is replaced by a roofline/XCCL
cost model, so a few virtual minutes of pod time take wall-clock
seconds and every run is byte-deterministic for a given seed. Every
figure printed is a MODELED CloudMatrix384 figure, not a measurement of
any card; the lines equal ``examples/sim_superpod.py``'s.

    PYTHONPATH=src python examples/torch_sim_superpod.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.sim import FaultPlan, SimConfig, SuperPodSim, WorkloadConfig


def show(tag: str, rep) -> None:
    s = rep.summary
    print(f"{tag:>22}: tpot={s['tpot_mean_s'] * 1e3:6.1f}ms  "
          f"ttft_p99={s['ttft_p99_s'] * 1e3:6.0f}ms  "
          f"{s['throughput_tok_s_per_die']:6.1f} tok/s/die  "
          f"finished={s['n_finished']}/{s['n_requests']}  "
          f"failovers={s['n_failovers']}")


def main() -> None:
    sim_cfg = SimConfig(n_sim_dps=8, eplb_interval_s=0.5)
    wl = WorkloadConfig(arrival_rate=80.0, duration_s=1.0, seed=11)

    sim = SuperPodSim(sim_cfg, wl)
    print(f"partition plan: {sim.plan.n_attention} attention dies + "
          f"{sim.plan.n_expert} expert dies in {sim.plan.n_dp_domains} "
          f"DP domains (the paper's 288/480 split)")

    show("healthy pod", sim.run())

    # a die starts thermal-throttling 0.3s in: its DP group's iterations
    # stretch and the fleet p99 follows
    show("straggler die (4x)", SuperPodSim(
        sim_cfg, wl, FaultPlan(straggler_dp=2, straggler_at=0.3,
                               straggler_slowdown=4.0)).run())

    # a DP group dies: the tiered heartbeat detects it, the balancer
    # stops routing there, active requests recompute elsewhere
    show("dead DP group", SuperPodSim(
        sim_cfg, wl, FaultPlan(dead_dp=1, dead_at=0.3)).run())

    # skewed expert popularity: hot expert dies gate every decode layer
    # until EPLB replicates them away
    skew = FaultPlan(expert_skew=0.8)
    show("hot experts, no EPLB", SuperPodSim(
        SimConfig(n_sim_dps=8, eplb_enabled=False), wl, skew).run())
    show("hot experts + EPLB", SuperPodSim(sim_cfg, wl, skew).run())


if __name__ == "__main__":
    main()
