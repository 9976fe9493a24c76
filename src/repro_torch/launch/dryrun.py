"""Multi-pod dry run: ``python -m repro_torch.launch.dryrun [--arch ...]
[--shape ...] [--mesh single|multi|both] [--out DIR] [--no-skip]
[--assigned-only]`` runs every (arch × input shape × mesh) combination's
step on ``meta`` tensors as rank 0 of the 16×16 or 2×16×16 mesh and
writes one JSON record each (``launch/dryrun_lib.py``). Nothing runs on
a card and no process group is made, so it needs neither.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, INPUT_SHAPES
from repro_torch.launch.dryrun_lib import run_many


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Multi-pod dry-run: run every (arch × input-shape × "
                    "mesh) combination's step on meta tensors.")
    ap.add_argument("--arch", action="append", default=None,
                    help="architecture id (repeatable); default: all 10 "
                         "assigned + the paper's deepseek-v3-671b")
    ap.add_argument("--shape", action="append", default=None,
                    choices=list(INPUT_SHAPES), help="input shape (repeatable)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-skip", action="store_true",
                    help="re-run combinations that already have results")
    ap.add_argument("--assigned-only", action="store_true",
                    help="only the 10 assigned archs (skip deepseek-v3-671b)")
    args = ap.parse_args(argv)

    archs = args.arch or (ASSIGNED_ARCHS if args.assigned_only else ALL_ARCHS)
    shapes = args.shape or list(INPUT_SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    run_many(archs, shapes, meshes, args.out,
             skip_existing=not args.no_skip)


if __name__ == "__main__":
    main()
