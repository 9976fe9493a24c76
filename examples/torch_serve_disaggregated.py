"""Disaggregated Prefill-Decode serving (paper §5.1) on the PyTorch/CUDA
port.

    PYTHONPATH=src python examples/torch_serve_disaggregated.py \
        [--device cuda]

Two prefill TEs (one on a UB fabric, one on a RoCE-like fabric, the
heterogeneous 910B case) and one decode TE, connected by isolated
DistFlow instances, every TE's DP groups on one device. Requests follow
the paper's 8-step workflow: JE routing → prefill → metadata-only
transfer registration → decode TE selection → KV-usage DP routing →
capacity-checked pull → transfer → completion queues.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config
from repro_torch.core import DisaggregatedPD
from repro_torch.serving.request import Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config("deepseek-moe-16b-smoke")
    print(f"serving {cfg.name}: MoE {cfg.moe.num_experts}e "
          f"top-{cfg.moe.top_k} + {cfg.moe.num_shared_experts} shared")
    pd = DisaggregatedPD(cfg, n_prefill_te=2, n_decode_te=1, dp_per_te=2,
                         max_batch=2, max_len=128, device=args.device,
                         prefill_fabrics=["ub", "roce"])
    reqs = [Request(prompt=p, max_new_tokens=10, ignore_eos=True)
            for p in ["disaggregate the transformer",
                      "attention is stateful, experts are stateless",
                      "trampoline forward balances the fan out",
                      "a" * 200]]   # a long one → long-capable TE
    done = pd.run_until_done(reqs)
    for r in sorted(done, key=lambda r: r.req_id):
        print(f"[req {r.req_id}] prefill_te={r.prefill_te} "
              f"decode_te={r.decode_te} dp={r.dp_group} "
              f"tokens={len(r.output_tokens)}")
    for pair, flow in pd.distflow.items():
        print(f"[distflow {pair}] fabric={flow.fabric} "
              f"bytes_moved={flow.bytes_moved/1e6:.2f}MB")
    pd.close()


if __name__ == "__main__":
    main()
