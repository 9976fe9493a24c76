#!/usr/bin/env python3
"""Hold two builds of the decode-attention kernel to the same outputs.

    python3 tools/decode_attention_same.py --src A/src --src B/src

Each ``src/`` tree's ``repro_torch`` builds its own
``kernels/csrc/decode_attention.cu`` (in that tree's ``build/``) and runs
its normalised ``decode_attention_cuda`` in a fresh process on the same
seeded inputs: bf16 and float32, every head dim, GQA groups of 1 to 10,
ring windows, ragged positions, one split and many. The outputs must be
bit-identical across the trees; prints one JSON line (the card's name
and power limit, the cases, and whether each matched).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

_CHILD = r"""
import sys
sys.path.insert(0, SRC)
import torch
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
out = {}
gen = torch.Generator().manual_seed(0)
for (B, H, KV, hd, L, window, pos) in CASES:
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((B, H, hd), generator=gen).to(dt).cuda()
        k = torch.randn((B, L, KV, hd), generator=gen).to(dt).cuda()
        v = torch.randn((B, L, KV, hd), generator=gen).to(dt).cuda()
        p = torch.tensor(pos, dtype=torch.int32).cuda()
        out[f"{B},{H},{KV},{hd},{L},{window},{pos},{dt}"] = \
            decode_attention_cuda(q, k, v, p, window=window).cpu()
torch.save(out, OUT)
"""

CASES = [(4, 40, 8, 128, 1024, 0, [1023, 1023, 1023, 1023]),
         (4, 40, 8, 128, 512, 0, [600, 511, 100, 0]),
         (4, 40, 8, 128, 32768, 0, [32767, 16384, 100, 0]),
         (2, 8, 4, 32, 64, 64, [70, 200]),
         (4, 10, 1, 256, 2048, 2048, [3000, 2047, 10, 5000]),
         (1, 16, 16, 64, 300, 0, [299])]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", required=True)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    import torch

    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate(args.src):
            path = os.path.join(tmp, f"{i}.pt")
            prog = (f"SRC = {str(Path(src).resolve())!r}\nOUT = {path!r}\n"
                    f"CASES = {CASES!r}\n" + _CHILD)
            res = subprocess.run([sys.executable, "-c", prog],
                                 capture_output=True, text=True,
                                 env=dict(os.environ, PYTHONPATH=""))
            if res.returncode:
                print(res.stderr[-3000:], file=sys.stderr)
                return res.returncode
            outs.append(torch.load(path))
    same = {k: all(torch.equal(o[k], outs[0][k]) for o in outs[1:])
            for k in outs[0]}
    print(json.dumps({"card": smi, "trees": args.src, "cases": len(same),
                      "bit_identical": all(same.values()),
                      "differ": [k for k, v in same.items() if not v]}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
