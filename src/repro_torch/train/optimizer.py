"""AdamW with a warm-up and cosine schedule, float32 moments, over the
port's parameter trees — the reference's arithmetic, operation for
operation: the gradients' global norm clips them, ``b ** step`` bias
corrections in float32, the decay added to the update (not applied to
the parameter as ``torch.optim.AdamW`` does), and the result cast back
to the parameter's dtype. No float32 master copy of the parameters is
kept, as in the reference.

On a mesh each rank holds its blocks of the parameters, gradients and
moments (``specs``, the model's parameter specs): the update is
elementwise on each block, and the global norm sums each leaf's squares
over the axes that cut it, never over those that replicate it, so every
rank clips by the reference's norm."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.launch.sharding import spec_axes
from repro_torch.models.common import (tree_leaves, tree_map,
                                       tree_unflatten_like)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar: updates taken
    m: PyTree                   # float32, the parameters' tree
    v: PyTree


def init_adamw(params: PyTree) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate after ``step`` updates (a tensor): linear
    warm-up, then a cosine from ``lr`` to ``lr · min_lr_ratio``."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: PyTree, ctx=None, specs: PyTree = None
                ) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's float32 sum of squares. ``ctx`` / ``specs``: the leaves are
    this rank's blocks under ``specs`` (a tree of ``PSpec`` like
    ``tree``); each leaf's sum is summed over the axes that cut it, one
    all-reduce per group of leaves with the same axes."""
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if ctx is not None and specs is not None:
        groups = {}
        for i, sp in enumerate(tree_leaves(specs)):
            cut = spec_axes(sp)
            axes = tuple(a for a in ctx.axis_names
                         if a in cut and ctx.axis_size(a) > 1)
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            tot = ctx.psum(torch.stack([sq[i] for i in idx]), axes)
            for j, i in enumerate(idx):
                sq[i] = tot[j]
    return torch.sqrt(torch.sum(torch.stack(sq)))



def adamw_update(cfg: AdamWConfig, params: PyTree, grads: PyTree,
                 state: AdamWState, ctx=None, specs: PyTree = None
                 ) -> Tuple[PyTree, AdamWState, dict]:
    """One step: → (new params, new state, {"grad_norm", "lr"}). Pure:
    the arguments are not written. ``ctx`` / ``specs``: the mesh and the
    parameters' specs (see :func:`global_norm`)."""
    with torch.no_grad():
        gnorm = global_norm(grads, ctx, specs)
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                           max=1.0)
        step = state.step + 1
        lr = lr_at(cfg, step)
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()

        def upd(p, g, m, v):
            g = g.float() * clip
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            delta = delta + cfg.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        out = [upd(*a) for a in zip(tree_leaves(params), tree_leaves(grads),
                                    tree_leaves(state.m),
                                    tree_leaves(state.v))]
        new_p, new_m, new_v = ([tree_unflatten_like(params, [o[i] for o in out])
                                for i in range(3)])
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm,
                                                   "lr": lr}
