"""Quickstart on the PyTorch/CUDA port: serve a smoke model end to end
with the port's FlowServe.

    PYTHONPATH=src python examples/torch_quickstart.py \
        [--arch internlm2-1.8b] [--device cuda]

Spins up the port's FlowServe engine (DP groups + TE-shell), submits a
few requests and prints their tokens. A model with cross-attention
(``--arch llama-3.2-vision-11b``, ``--arch seamless-m4t-medium``) is
fed a memory made from a fixed seed: the patch embeddings or audio
frames its stubbed frontend would give. Runs on the card unless ``--device
cpu`` asks for the CPU (the kernels' plain versions).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import Model, seeded_memory
from repro_torch.serving.flowserve import FlowServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--dp-groups", type=int, default=2)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch + "-smoke")
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={cfg.param_count()/1e6:.1f}M (reduced smoke variant)")
    memory = None
    if Model(cfg).has_cross:
        memory = seeded_memory(
            cfg, torch.Generator(device=device).manual_seed(0), device)
    engine = FlowServeEngine(cfg, device=device,
                             n_dp_groups=args.dp_groups, max_batch=2,
                             max_len=128, memory=memory)

    prompts = [
        "the expert dispatch routes tokens",
        "cloudmatrix has 384 chips",
        "prefill is compute bound, decode is memory bound",
    ]
    reqs = [engine.submit_text(p, args.max_new_tokens, ignore_eos=True)
            for p in prompts]
    engine.run_until_done()
    for r in reqs:
        text = engine.tokenizer.decode(r.output_tokens)
        print(f"[req {r.req_id}] ttft={r.ttft*1e3:.0f}ms "
              f"tpot={r.tpot*1e3:.1f}ms/token -> {text!r}")
    for dp in engine.dps:
        s = dp.status()
        print(f"[dp {s.dp_id}] kv_usage={s.kv_usage:.2f} "
              f"prefix_cache={len(dp.prefix_cache)} entries "
              f"gc_collections={dp.gc_ctl.collections}")
    engine.close()


if __name__ == "__main__":
    main()
