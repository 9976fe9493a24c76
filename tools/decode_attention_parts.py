#!/usr/bin/env python3
"""Decode attention on the card in parts, for one or more builds.

    python3 tools/decode_attention_parts.py --src A/src [--src B/src]
        [--sweep] [--out FILE]

Each ``src/`` tree's ``repro_torch`` builds its own
``kernels/csrc/decode_attention.cu`` (in that tree's ``build/``) and is
timed in a fresh process, under ``torch.profiler`` (device ms per call,
50 calls after warm-up), at the decode shapes the served paths run
(bf16, every slot valid): RecurrentGemma-2B's ring (B 4 and 8, 10 heads
on one KV head, hd 256, L = window 2048), Llama-3.2-Vision's cross (L
1601) and self (L 256) attention, SeamlessM4T's cross (L 512) and self
(L 256) attention and its partial output on half the cross memory, the
partial output of a Llama-4 shard (512 of 1024 slots), and Llama-4's
decode at L 1024 and 8192. For each shape:

* ``plan``: the call as the wrapper plans it (``kernel.plan``);
* ``walk``: the same blocks walking the same ranges with nothing to
  merge: ``n_split`` forced to 1 over one range, with the rows
  multiplied by the plan's ``n_split`` so that the card holds as many
  blocks;
* ``sdpa``: ``scaled_dot_product_attention`` on the same inputs;

and at RecurrentGemma B 4, the call with 4, 8 and 10 query heads on the
one K/V (1, 2 and 3 head groups where a block takes 4 heads). With
``--sweep`` each shape is also timed at every split of its cache into
1-8, 16, 32 and 64 ranges (a tree whose plan names a ``cluster`` merges
up to 8 ranges in a cluster), beside the error against the plain
version. Forced launches go through the tree's own wrapper with its
``plan`` replaced. Prints the card's name and power limit, then one JSON
line per tree (also written to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

#: name → (B, H, KV, hd, L, window, partial)
ROWS = {
    "rg ring B4": (4, 10, 1, 256, 2048, 2048, False),
    "rg ring B8": (8, 10, 1, 256, 2048, 2048, False),
    "vlm cross L1601": (4, 32, 8, 128, 1601, 0, False),
    "vlm self L256": (4, 32, 8, 128, 256, 0, False),
    "m4t cross L512": (4, 16, 16, 64, 512, 0, False),
    "m4t self L256": (4, 16, 16, 64, 256, 0, False),
    "m4t cross shard 256 (partial)": (4, 16, 16, 64, 256, 0, True),
    "llama4 shard 512 (partial)": (4, 40, 8, 128, 512, 0, True),
    "llama4 L1024": (4, 40, 8, 128, 1024, 0, False),
    "llama4 L8192": (4, 40, 8, 128, 8192, 0, False),
}
SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 16, 32, 64)


def device_ms(fn, reps: int = 50):
    """Device ms per call under the profiler, or None where it recorded
    no kernel (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA" and e.count)
    return total / reps / 1e3 if total else None


def child(src: str, sweep: bool) -> dict:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels.decode_attention import kernel as K
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, valid_slots)

    orig = K.plan
    n_sms = K._n_sms(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(30)

    def forced(over):
        """Replace the tree's plan by ``over`` of it (None: its own)."""
        def f(*a, **kw):
            p = dict(orig(*a, **kw))
            return {**p, **over(p)} if over else p
        K.plan = f
        getattr(K, "_CALLS", {}).clear()

    def split(n, L):
        def over(p):
            tiles = -(-L // 64)
            sl = 64 * -(-tiles // n)
            ns = -(-L // sl)
            o = dict(split_len=sl, n_split=ns,
                     grid=(ns,) + tuple(p["grid"][1:]))
            if "cluster" in p:
                o["cluster"] = ns if 1 < ns <= 8 else 1
            return o
        return over

    def inputs(B, H, KV, hd, L, window):
        q, k, v = ((torch.randn(s, generator=gen, device="cuda") * 0.5)
                   .bfloat16() for s in ((B, H, hd), (B, L, KV, hd),
                                         (B, L, KV, hd)))
        pos = torch.full((B,), 3000 if window else L - 1, dtype=torch.int32,
                         device="cuda")
        return q, k, v, pos

    def call(q, k, v, pos, window, partial):
        return lambda: K.decode_attention_cuda(q, k, v, pos, window=window,
                                               partial=partial)

    out = {}
    for name, (B, H, KV, hd, L, window, partial) in ROWS.items():
        q, k, v, pos = inputs(B, H, KV, hd, L, window)
        forced(None)
        p = orig(B, H, KV, hd, L, n_sms)
        row = dict(plan={k_: v_ for k_, v_ in p.items() if k_ != "grid"},
                   plan_ms=device_ms(call(q, k, v, pos, window, partial)))
        mask = valid_slots(pos, L, window)[:, None, None, :]
        row["sdpa_ms"] = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True))
        n = p["n_split"]
        if n > 1:       # the same blocks, each one range and no merge
            Lw = p["split_len"]
            qw, kw, vw, pw = inputs(B * n, H, KV, hd, Lw, window)
            forced(lambda _p: dict(split_len=Lw, n_split=1, cluster=1,
                                   grid=(1,) + tuple(_p["grid"][1:])))
            row["walk_ms"] = device_ms(call(qw, kw, vw, pw, window, partial))
        else:
            row["walk_ms"] = row["plan_ms"]
        if sweep:
            want = decode_attention_ref(q, k, v, pos, window=window)
            row["sweep"] = {}
            for ns in SPLITS:
                if ns > -(-L // 64):
                    continue
                forced(split(ns, L))
                fn = call(q, k, v, pos, window, False)
                err = (fn() - want).abs().max().item()
                row["sweep"][ns] = dict(
                    split_len=K.plan(B, H, KV, hd, L, n_sms)["split_len"],
                    ms=device_ms(fn), max_abs_err=err)
        forced(None)
        out[name] = row
        print(json.dumps({name: row}), file=sys.stderr, flush=True)
    B, KV, hd, L = 4, 1, 256, 2048
    out["rg heads on one K/V"] = {}
    for H in (4, 8, 10):
        q, k, v, pos = inputs(B, H, KV, hd, L, L)
        out["rg heads on one K/V"][H] = dict(
            plan=orig(B, H, KV, hd, L, n_sms)["n_grp"],
            ms=device_ms(call(q, k, v, pos, L, False)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.src[0], args.sweep)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    results = []
    for src in args.src:
        cmd = [sys.executable, __file__, "--child", "--src",
               str(Path(src).resolve())] + (["--sweep"] if args.sweep else [])
        res = subprocess.run(cmd, capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=""))
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        results.append(dict(card=smi, tree=src,
                            rows=json.loads(res.stdout.splitlines()[-1])))
        print(json.dumps(results[-1]), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
