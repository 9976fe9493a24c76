"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Trains on the card unless ``--device cpu`` asks for the CPU (the
plain PyTorch versions everywhere; training launches no hand kernel on
either device). Prints the reference launcher's line every
``--log-every`` steps.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import get_config


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant of the arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   Trainer)

    name = args.arch + ("-smoke" if args.smoke else "")
    cfg = get_config(name)
    tcfg = TrainConfig(
        steps=args.steps, log_every=args.log_every,
        ckpt_dir=args.ckpt_dir,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps),
        data=DataConfig(seq_len=args.seq_len, global_batch=args.batch))
    tr = Trainer(cfg, tcfg, device=args.device)
    tr.maybe_restore()
    tr.run(on_log=lambda r: print(
        f"step {r['step']:5d}  loss {r['loss']:.4f}  nll {r['nll']:.4f}  "
        f"gnorm {r['grad_norm']:.2f}  lr {r['lr']:.2e}  "
        f"{r['wall_s']:.1f}s", flush=True))


if __name__ == "__main__":
    main()
