"""Griffin / RecurrentGemma recurrent block with the RG-LRU, as the
reference's ``models/rglru.py``.

[arXiv:2402.19427]. Block structure (the "recurrent block"):
  x ── linear ─ conv1d ─ RG-LRU ─┐
  x ── linear ─ GeLU ────────────┤ ⊙ ── linear ── out
RG-LRU recurrence (per channel, in float32):
  r_t = σ(W_a x_t + b_a)         (recurrence gate, block-diagonal)
  i_t = σ(W_x x_t + b_x)         (input gate, block-diagonal)
  a_t = exp(-c · softplus(Λ) · r_t)            c = 8
  h_t = a_t h_{t-1} + sqrt(max(1 - a_t², 1e-12)) · (i_t ⊙ x_t)
Prefill evaluates the linear recurrence with a log-depth scan
(``common.linear_scan``) from a zero state; decode is the O(1) update,
written in place into the layer's cache: ``state`` [B, width] float32
and ``conv`` [B, conv_width - 1, width], the causal conv's history, in
the model dtype. A prefill folds every position it is given into both,
the bucket's pad tokens included, as the reference does.

On a mesh (``ctx``, ``specs`` the layer's parameter specs as the rank
holds them) the rows are this rank's batch block, and where ``w_in``,
``w_gate_branch`` and ``w_out`` are cut over the TP axis (the ``"lru"``
rule) each TP rank computes its block of the channels: its columns of
the two input projections, its blocks of the block-diagonal gates, its
slices of ``lam`` and the conv, and its rows of ``w_out``, whose partial
products are summed over the axis in float32. The cache keeps the whole
width on every rank (``cache_pspecs`` cuts only the batch): each step
reads this rank's channels of it and all-gathers the new ``state``
(float32) and ``conv`` history back. A cut that does not fall on a gate
block's edge gathers the weights and runs every channel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import linear_scan

Cache = Dict[str, torch.Tensor]
_C = 8.0


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def _blocks(cfg: ModelConfig) -> Tuple[int, int]:
    """(nb, bw): the block-diagonal gates' blocks and their width."""
    w, h = _width(cfg), cfg.num_heads
    bw = w // h if w % h == 0 else w
    return w // bw, bw


def init_lam(shape, generator, device) -> torch.Tensor:
    """Λ such that a = exp(-c softplus(Λ)) spans (0.9, 0.999) at r = 1
    over the last axis (the paper's init; no draw)."""
    a = torch.linspace(0.9, 0.999, shape[-1], dtype=torch.float32,
                       device=device)
    return torch.log(torch.expm1(-torch.log(a) / _C)).expand(shape).clone()


def rglru_param_shapes(cfg: ModelConfig):
    """name → (shape, init, fan_in, float32?): init "dense" (fan-in
    truncated normal), "zeros" or :func:`init_lam`; float32 leaves stay
    float32 whatever the model dtype."""
    d, w, K = cfg.d_model, _width(cfg), cfg.rglru.conv_width
    nb, bw = _blocks(cfg)
    return {
        "w_in": ((d, w), "dense", d, False),
        "w_gate_branch": ((d, w), "dense", d, False),
        "conv_w": ((K, w), "dense", K, False),
        "conv_b": ((w,), "zeros", 0, False),
        "gate_a_w": ((nb, bw, bw), "dense", bw, True),
        "gate_a_b": ((nb, bw), "zeros", 0, True),
        "gate_x_w": ((nb, bw, bw), "dense", bw, True),
        "gate_x_b": ((nb, bw), "zeros", 0, True),
        "lam": ((w,), init_lam, 0, True),
        "w_out": ((w, d), "dense", w, False),
    }


def rglru_cache_spec(cfg: ModelConfig, batch: int, dtype):
    """name → (shape, dtype)."""
    w = _width(cfg)
    return {"state": ((batch, w), torch.float32),
            "conv": ((batch, cfg.rglru.conv_width - 1, w), dtype)}


def causal_conv(x, w, b, history=None):
    """Depthwise causal conv: x [B, S, C], w [K, C], history [B, K-1, C]
    (zeros when None) → (y [B, S, C], the last K-1 inputs), summed tap
    by tap in x's dtype, in the reference's order."""
    K, S = w.shape[0], x.shape[1]
    if history is None:
        history = torch.zeros((x.shape[0], K - 1, x.shape[2]),
                              dtype=x.dtype, device=x.device)
    xp = torch.cat([history, x], dim=1)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return y + b, (xp[:, -(K - 1):] if K > 1 else history)


def _block_diag(x, w, b):
    """x [B, S, width] → the per-block linear map, float32; w [nb, bw,
    bw]."""
    B, S, width = x.shape
    nb, bw, _ = w.shape
    y = torch.einsum("bsnw,nwv->bsnv", x.reshape(B, S, nb, bw).float(),
                     w) + b
    return y.reshape(B, S, width)


def _channel_split(params, cfg: ModelConfig, ctx, specs):
    """(params as this rank computes with them, TP axis or None, first
    channel): this rank's block of every per-channel leaf where the
    ``"lru"`` dim is cut over the TP axis on a gate block's edge; the
    weights gathered whole (axis None) where the cut is not aligned."""
    tp = ctx.tp_axis
    cut = specs is not None and ctx.tp_size > 1 and all(
        specs[n].entry(dim) == tp for n, dim in
        (("w_in", 1), ("w_gate_branch", 1), ("w_out", 0)))
    if not cut:
        return params, None, 0
    bw = _blocks(cfg)[1]
    w_loc = params["w_in"].shape[1]
    if w_loc % bw:
        p = dict(params)
        for n, dim in (("w_in", 1), ("w_gate_branch", 1), ("w_out", 0)):
            p[n] = ctx.all_gather(params[n], tp, dim=dim)
        return p, None, 0
    c0 = ctx.axis_index(tp) * w_loc
    g0, g1 = c0 // bw, (c0 + w_loc) // bw
    p = dict(params)
    p["conv_w"] = params["conv_w"][:, c0:c0 + w_loc]
    for n in ("conv_b", "lam"):
        p[n] = params[n][c0:c0 + w_loc]
    for n in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b"):
        p[n] = params[n][g0:g1]
    return p, tp, c0


def rglru_apply(params, x, *, cfg: ModelConfig, mode: str,
                cache: Optional[Cache] = None, ctx=None, specs=None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x [B, S, d] → (y [B, S, d], cache). ``prefill`` returns a fresh
    cache, ``train`` none; ``decode`` (S = 1) updates ``cache`` in
    place. ``ctx`` / ``specs``: the mesh and the layer's parameter specs
    (see the module docstring; None: one device)."""
    if mode not in ("prefill", "train", "decode"):
        raise ValueError(f"rglru_apply: unsupported mode {mode!r}")
    axis, c0 = None, 0
    if ctx is not None:
        params, axis, c0 = _channel_split(params, cfg, ctx, specs)
    w_loc = params["w_in"].shape[1]
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, params["w_gate_branch"]),
                  approximate="tanh")
    u = torch.einsum("bsd,dw->bsw", x, params["w_in"])
    # this rank's channels of the whole-width cache
    hist = cache["conv"][..., c0:c0 + w_loc] if mode == "decode" else None
    u, new_hist = causal_conv(u, params["conv_w"], params["conv_b"], hist)

    r = torch.sigmoid(_block_diag(u, params["gate_a_w"], params["gate_a_b"]))
    i = torch.sigmoid(_block_diag(u, params["gate_x_w"], params["gate_x_b"]))
    log_a = -_C * F.softplus(params["lam"]) * r               # [B,S,w] f32
    a = torch.exp(log_a)
    gated_x = i * u.float()
    b_t = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated_x

    def whole(t, dim):
        # this rank's channels → the whole width (f32 state travels f32)
        return t if axis is None else ctx.all_gather(t.contiguous(), axis,
                                                     dim=dim)
    if mode == "decode":
        h = a[:, 0] * cache["state"][:, c0:c0 + w_loc] + b_t[:, 0]
        cache["state"].copy_(whole(h, 1))
        cache["conv"].copy_(whole(new_hist, 2))
        y, new_cache = h[:, None], cache
    else:
        y = linear_scan(a, b_t, dim=1)                         # h_t
        new_cache = ({"state": whole(y[:, -1], 1).contiguous(),
                      "conv": whole(new_hist, 2).contiguous()}
                     if mode == "prefill" else None)
    y = (y * gate.float()).to(x.dtype)
    y = torch.einsum("bsw,wd->bsd", y, params["w_out"])
    if axis is not None:
        y = ctx.psum(y.float(), axis).to(y.dtype)
    return y, new_cache
