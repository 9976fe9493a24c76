"""End-to-end training on the PyTorch/CUDA port: a ~100M-parameter MoE
trained for a few hundred steps on the synthetic corpus, with
checkpoints and the MoE aux losses.

    PYTHONPATH=src python examples/torch_train_moe.py [--steps 300] \
        [--device cuda]

The reference's ``examples/train_moe.py`` on the port: the same model,
schedule and printed lines. Trains on the card unless ``--device cpu``
asks for the CPU; training runs the plain versions of the MoE kernels
on either (they have no backward). Checkpoints go to ``--ckpt-dir``
(default: ``repro_torch_moe_ckpt`` in the temporary directory).
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_moe_ckpt"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import ATTN, MLP, MOE, ModelConfig, MoEConfig
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                                   Trainer)

    # ~100M-param fine-grained MoE (deepseek-moe style, scaled down)
    cfg = ModelConfig(
        name="moe-100m", family="moe",
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=4096,
        prefix_layers=((ATTN, MLP),),
        layer_pattern=((ATTN, MOE),),
        moe=MoEConfig(num_experts=8, num_shared_experts=1, top_k=2,
                      expert_d_ff=512, shared_d_ff=512,
                      capacity_factor=1.5),
    )
    print(f"params: {cfg.param_count()/1e6:.1f}M "
          f"(active {cfg.active_param_count()/1e6:.1f}M)")

    tcfg = TrainConfig(
        steps=args.steps, log_every=20, ckpt_every=100,
        ckpt_dir=args.ckpt_dir,
        opt=AdamWConfig(lr=6e-4, warmup_steps=30, total_steps=args.steps),
        data=DataConfig(seq_len=args.seq_len, global_batch=args.batch))
    tr = Trainer(cfg, tcfg, device=args.device)
    tr.maybe_restore()
    tr.run(on_log=lambda r: print(
        f"step {r['step']:4d}  loss {r['loss']:.4f}  nll {r['nll']:.4f}  "
        f"lb {r['moe_lb_loss']:.4f}  gnorm {r['grad_norm']:.2f}  "
        f"{r['wall_s']:.0f}s", flush=True))
    first, last = tr.history[0], tr.history[-1]
    print(f"\nnll: {first['nll']:.3f} -> {last['nll']:.3f} "
          f"over {last['step'] - first['step']} steps; "
          f"checkpoints in {args.ckpt_dir}")


if __name__ == "__main__":
    main()
