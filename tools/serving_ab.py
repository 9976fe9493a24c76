#!/usr/bin/env python3
"""A/B measurements of the port's served paths on one NVIDIA GPU.

Run from the repository root:

``python3 tools/serving_ab.py combine``
    Host-clock cost of the MoE combine: ``index_add_`` (atomics on the
    card, the order of a token's adds not fixed) against the order-fixed
    ``ffn.combine_assignments``, per call at DeepSeek-V3's width, then a
    full decode step of one DeepSeek-V3 DP group (depth 4, B 4) with
    each, alternating.

``python3 tools/serving_ab.py ttft [--pairs N] [--paths deepseek llama]``
    Time to first token of ``chip_smoke.py``'s two served waves, each
    sample a fresh process (so the first wave pays the cold costs a
    process pays), variants called in turn (A B, then B A, ...):
    DeepSeek-V3 (depth 4) with either combine, and Llama-4 Maverick
    (depth 2) served with or without ``chip_smoke.py``'s decode-attention
    stage (long caches up to L 131072, then ``empty_cache``) run just
    before it. Prints each sample and the medians per variant.

Both print the card's name and power limit last.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

VARIANTS = {"deepseek": ("index_add", "ordered"),
            "llama": ("serve_first", "attention_first")}


def old_combine(wa, k):
    """The combine before it was order-fixed: one ``index_add_``."""
    T = wa.shape[0] // k
    tok_of = torch.arange(T, device=wa.device).repeat_interleave(k)
    return torch.zeros((T, wa.shape[1]), dtype=wa.dtype,
                       device=wa.device).index_add_(0, tok_of, wa)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def combine() -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import ffn
    from repro_torch.serving.flowserve import FlowServeEngine

    new = ffn.combine_assignments
    for name, T in (("decode T=4", 4), ("prefill T=64", 64)):
        wa = torch.randn(T * 8, 7168, device="cuda")
        for label, fn in (("old", old_combine), ("new", new),
                          ("old", old_combine), ("new", new)):
            for _ in range(20):
                fn(wa, 8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn(wa, 8)
            torch.cuda.synchronize()
            print(f"combine {name} {label}: "
                  f"{(time.perf_counter() - t0) / 2000 * 1e3:.4f} ms per "
                  f"call (back to back)")

    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), num_layers=4,
                              mtp_num_layers=0)
    eng = FlowServeEngine(cfg, device="cuda", n_dp_groups=1, seed=0,
                          max_batch=4)
    be = eng.dps[0].backend
    cache = be.init_cache(4, 256)
    tok = torch.arange(7, 11, dtype=torch.int32, device="cuda")[:, None]
    pos = torch.tensor([20, 30, 40, 50], dtype=torch.int32, device="cuda")
    res = {"old": [], "new": []}
    with torch.no_grad():
        for rnd in range(6):
            order = ((("old", old_combine), ("new", new)) if rnd % 2 == 0
                     else (("new", new), ("old", old_combine)))
            for label, fn in order:
                ffn.combine_assignments = fn
                for _ in range(3):
                    be.model.decode_step(be.params, cache, tok, pos)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(30):
                    logits, _ = be.model.decode_step(be.params, cache, tok,
                                                     pos)
                    logits.argmax(-1).cpu()
                res[label].append((time.perf_counter() - t0) / 30 * 1e3)
    ffn.combine_assignments = new
    for k, v in res.items():
        print(f"decode step (one DP group, B 4) {k}: median "
              f"{statistics.median(v):.3f} ms, runs "
              f"{[round(x, 3) for x in v]}")
    eng.close()


def child(path: str, variant: str) -> None:
    """One sample: make the engine, serve both waves as chip_smoke.py's
    ``run_path`` does, print one JSON line."""
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import ffn

    if path == "deepseek":
        cfg = dataclasses.replace(get_config(cs.DEEPSEEK), num_layers=4,
                                  mtp_num_layers=0)
        if variant == "index_add":
            ffn.combine_assignments = old_combine
        engine = cs.make_engine(cfg, max_batch=4)
        prompts, prompts_eplb = cs.PROMPTS, cs.PROMPTS_EPLB
    else:
        cfg = dataclasses.replace(get_config(cs.LLAMA), num_layers=2)
        engine = cs.make_engine(cfg, max_batch=4, max_len=1024,
                                chunk_tokens=512)
        if variant == "attention_first":
            cs.check_decode_attention(cfg, 4, 1024)
            cs.free("decode attention")
        prompts, prompts_eplb = cs.LLAMA_PROMPTS, cs.LLAMA_PROMPTS_EPLB
    reqs, _ = cs.serve(engine, prompts, 16)
    engine.record_expert_counts(cs.skewed_counts(cfg))
    engine.run_eplb()
    reqs2, _ = cs.serve(engine, prompts_eplb, 16)
    engine.close()
    print(json.dumps(dict(
        path=path, variant=variant,
        ttft_wave1_ms=1e3 * statistics.mean(r.ttft for r in reqs),
        ttft_wave2_ms=1e3 * statistics.mean(r.ttft for r in reqs2),
        tpot_ms=1e3 * statistics.mean(r.tpot for r in reqs + reqs2))))


def ttft(pairs: int, paths) -> None:
    from repro_torch.kernels import runtime

    runtime.build()                      # the children find it built
    samples = []
    for path in paths:
        a, b = VARIANTS[path]
        for i in range(pairs):
            for variant in ((a, b) if i % 2 == 0 else (b, a)):
                out = subprocess.run(
                    [sys.executable, __file__, "child", path, variant],
                    capture_output=True, text=True, cwd=ROOT)
                if out.returncode != 0:
                    raise RuntimeError(f"{path}/{variant} failed:\n"
                                       f"{out.stdout[-2000:]}"
                                       f"{out.stderr[-4000:]}")
                line = json.loads(out.stdout.strip().splitlines()[-1])
                samples.append(line)
                print(json.dumps(line), flush=True)
    for path in paths:
        for variant in VARIANTS[path]:
            got = [s for s in samples
                   if s["path"] == path and s["variant"] == variant]
            med = {k: statistics.median(s[k] for s in got)
                   for k in ("ttft_wave1_ms", "ttft_wave2_ms", "tpot_ms")}
            print(f"{path} {variant}: medians over {len(got)} processes "
                  + ", ".join(f"{k} {v:.2f}" for k, v in med.items()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    sub.add_parser("combine")
    t = sub.add_parser("ttft")
    t.add_argument("--pairs", type=int, default=4)
    t.add_argument("--paths", nargs="+", choices=sorted(VARIANTS),
                   default=sorted(VARIANTS))
    c = sub.add_parser("child")
    c.add_argument("path", choices=sorted(VARIANTS))
    c.add_argument("variant")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device available", file=sys.stderr)
        return 1
    if args.mode == "combine":
        combine()
    elif args.mode == "ttft":
        ttft(args.pairs, args.paths)
    else:
        child(args.path, args.variant)
        return 0
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
