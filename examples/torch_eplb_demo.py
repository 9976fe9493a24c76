"""EPLB walkthrough (paper §4.5, Fig. 12) on the PyTorch/CUDA port:
collect → select → place → reconfig → rotation-balanced routing.

    PYTHONPATH=src python examples/torch_eplb_demo.py [--device cuda]

The last step routes tokens through the placement table on
``--device``, by the rule the MoE layer's decode path runs
(``placement_route``).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.kernels.route_pack.ops import placement_route
from repro_torch.models.common import resolve_device
from repro_torch.serving.eplb import (ExpertLoadCollector,
                                      ExpertReconfigurator,
                                      build_expert_map,
                                      build_placement_table,
                                      select_redundant_experts,
                                      simulated_layer_load)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    E, NPUS, LAYERS = 64, 16, 4

    # step 1: collect token counts (the Collect kernel output)
    col = ExpertLoadCollector(LAYERS, E)
    pop = rng.zipf(1.3, size=E).astype(float)
    for _ in range(6):
        step = rng.poisson(pop[None, :] * 40, size=(LAYERS, E))
        col.record(step)
        col.end_slice()
    counts = col.token_count          # [L, E, T]
    layer0 = counts[0]
    print(f"hottest/avg load: "
          f"{layer0.sum(1).max() / layer0.sum(1).mean():.1f}x")

    # step 2: EPLB selection + placement
    chosen = select_redundant_experts(layer0, budget=8)
    base = simulated_layer_load(layer0, {e: 1 for e in range(E)})
    reps = {e: 1 for e in range(E)}
    for e in chosen:
        reps[e] += 1
    print(f"replicating experts {chosen}")
    print(f"simulated layer load: {base:.0f} -> "
          f"{simulated_layer_load(layer0, reps):.0f}")

    # steps 3+4: phased reconfig (prefetch → shadow-load → swap) +
    # rotation mapping
    em = build_expert_map(layer0, E, budget=8, n_npus=NPUS)
    swapped = []
    rc = ExpertReconfigurator(apply_fn=swapped.append,
                              bytes_per_replica=1)
    plan = rc.begin(em)
    print(f"migration: {plan.n_replica_loads} replica loads "
          f"(hottest NPU {plan.hottest_npu_loads})")
    while rc.step() != 4:
        pass
    assert swapped, "swap phase must install the new placement"
    print(f"reconfig complete in {rc.steps_to_converge} phases; "
          f"physical slots: {em.n_physical}")

    # communication-free rotation: tokens at different batch positions
    # hit different replicas of the same logical expert (Fig. 12), routed
    # on the device through the layer's placement table
    hot = chosen[0]
    table = build_placement_table([em], E)
    slots, n_rep = (torch.as_tensor(a[0], device=device)
                    for a in (table.replica_slots, table.n_replicas))
    phys = placement_route(torch.full((8,), hot, device=device),
                           torch.arange(8, device=device), slots,
                           n_rep).cpu()
    print(f"logical expert {hot} replicas {em.replicas[hot]} -> "
          f"positions 0..7 route to physical slots {phys.tolist()}")


if __name__ == "__main__":
    main()
