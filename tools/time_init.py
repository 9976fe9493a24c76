#!/usr/bin/env python3
"""Time ``Model.init`` of a full-width configuration on the card.

    python3 tools/time_init.py [--src DIR ...] [--arch NAME] [--layers N]
                               [--host-elems N]

Each ``--src`` is a ``src/`` tree holding a ``repro_torch`` package (the
default is this checkout's); each is timed in a fresh process, in turn,
so that two versions of the port compare on one card in one call. For
each: the seconds ``Model(cfg).init(0, device="cuda")`` takes (to a
synchronised card), the parameter count, the card's name and power limit
(``nvidia-smi``), and, with ``--host-elems``, the seconds the same
init's code takes to draw that many elements of a dense leaf on the
host (``device="cpu"``). Prints one JSON line per tree.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import dataclasses, json, math, sys, time
sys.path.insert(0, SRC)
import torch
from repro_torch.configs import get_config
from repro_torch.models.common import dense_init
from repro_torch.models.transformer import Model
from repro_torch.models.weights import flatten
cfg = get_config(ARCH)
if LAYERS:
    cfg = dataclasses.replace(cfg, num_layers=LAYERS)
m = Model(cfg)
torch.cuda.synchronize()
t0 = time.monotonic()
params = m.init(0, device="cuda")
torch.cuda.synchronize()
out = dict(src=SRC, arch=ARCH, layers=cfg.num_layers,
           params=sum(t.numel() for t in flatten(params).values()),
           init_s=time.monotonic() - t0)
del params
if HOST:
    side = int(math.isqrt(HOST))
    try:
        t0 = time.monotonic()
        dense_init((side, HOST // side), torch.bfloat16, side, 5, "cpu")
        out["host_elems"] = side * (HOST // side)
        out["host_s"] = time.monotonic() - t0
    except TypeError:             # a tree whose init takes a generator
        out["host_s"] = None
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=None)
    ap.add_argument("--arch", default="deepseek-v3-671b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--host-elems", type=int, default=0)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for src in args.src or [str(ROOT / "src")]:
        prog = (f"SRC = {str(Path(src).resolve())!r}\nARCH = {args.arch!r}\n"
                f"LAYERS = {args.layers}\nHOST = {args.host_elems}\n"
                + _CHILD)
        res = subprocess.run([sys.executable, "-c", prog],
                             capture_output=True, text=True,
                             env=dict(os.environ, PYTHONPATH=""))
        if res.returncode:
            print(res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(line, card=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
