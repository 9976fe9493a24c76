"""Serving launcher.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --smoke --mode pd-disagg --prompt "hello" --prompt "world"

Modes: ``colocated`` (single FlowServe TE) and ``pd-disagg`` (§5.1
pipeline: prefill TEs + decode TE over DistFlow). Runs on the card
unless ``--device cpu`` asks for the CPU (the plain PyTorch versions of
the kernels).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import get_config


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="use the full config (needs matching hardware)")
    ap.add_argument("--mode", choices=["colocated", "pd-disagg"],
                    default="colocated")
    ap.add_argument("--prompt", action="append", default=None)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--dp-groups", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    prompts = args.prompt or ["hello from xdeepserve"]

    if args.mode == "colocated":
        from repro_torch.serving.flowserve import FlowServeEngine
        eng = FlowServeEngine(cfg, device=args.device,
                              n_dp_groups=args.dp_groups, max_batch=2,
                              max_len=256)
        outs = eng.generate(prompts, args.max_new_tokens,
                            temperature=args.temperature)
        for p, o in zip(prompts, outs):
            print(f"{p!r} -> {o!r}")
        eng.close()
    else:
        from repro_torch.core import DisaggregatedPD
        from repro_torch.serving.request import Request
        pd = DisaggregatedPD(cfg, n_prefill_te=2, n_decode_te=1,
                             dp_per_te=args.dp_groups, max_batch=2,
                             max_len=256, device=args.device)
        reqs = [Request(prompt=p, max_new_tokens=args.max_new_tokens,
                        temperature=args.temperature, ignore_eos=True)
                for p in prompts]
        done = pd.run_until_done(reqs)
        tok = pd.tokenizer
        for r in sorted(done, key=lambda r: r.req_id):
            print(f"{r.prompt!r} (p{r.prefill_te}->d{r.decode_te}) -> "
                  f"{tok.decode(r.output_tokens)!r}")
        pd.close()


if __name__ == "__main__":
    main()
