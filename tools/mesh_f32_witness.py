#!/usr/bin/env python3
"""Two ranks against one device in float32 at full width, on the card.

    python3 tools/mesh_f32_witness.py [--arch NAME ...] [--mesh 1x2|2x1]

For each ``--arch`` (default RecurrentGemma-2B and SeamlessM4T-medium)
at full width and depth in float32: the global logits of
``chip_smoke.t_logits`` (a [4, 32] seeded prefill, then 4 decode steps;
the seeded memory where the model reads one) on one device, then on two
ranks sharing the card over gloo on ``--mesh`` (default (1,2): the
channels, heads and MLP over TP, the caches' slots cut), each rank
holding its blocks of the seed's weights. Prints the card's name and
power limit, then one JSON line per arch: the largest relative error of
each logit set across the ranks, and whether the ranks' logits are
identical. In bfloat16 stage T of ``chip_smoke.py`` holds the same
comparison to 0.08; float32 tells rounding from a fault.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

MESHES = {"1x2": ((1, 2), False), "2x1": ((2, 1), True)}


def f32(arch):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), dtype="float32")


def rank(rank, world, init, arch, mname, inputs):
    """One rank: its blocks of the seed's weights, the global logits."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model

    shape, decode_rules = MESHES[mname]
    mesh = init_mesh(shape, "gloo", "cuda", rank=rank, world_size=world,
                     init_method=init)
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",), remat="none")
    cfg = f32(arch)
    model = Model(cfg, ctx=ctx,
                  rules=shd.DECODE_RULES if decode_rules else None)
    params = model.init(0, device="cuda")
    return cs.t_logits(model, params, *inputs, cs.t_memory(cfg))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", action="append")
    p.add_argument("--mesh", default="1x2", choices=sorted(MESHES))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("mesh_f32_witness: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.transformer import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for arch in args.arch or [cs.RG, cs.SEAMLESS]:
        cfg = f32(arch)
        inputs = cs.r_inputs(cfg)
        params = Model(cfg).init(0, device="cuda")
        want = cs.t_logits(Model(cfg), params, *inputs, cs.t_memory(cfg))
        del params
        cs.free(f"{arch} one device")
        got = spawn(rank, 2, arch, args.mesh, inputs, threads=4)
        errs = {k: max(float((g[k] - v).abs().max() / v.abs().max())
                       for g in got) for k, v in want.items()}
        print(json.dumps(dict(
            arch=arch, mesh=args.mesh, dtype="float32", rel_err=errs,
            ranks_identical=all(torch.equal(got[0][k], g[k])
                                for g in got for k in want))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
