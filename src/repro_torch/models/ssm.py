"""Mamba-2 block with the SSD (state-space duality) algorithm, as the
reference's ``models/ssm.py``.

[arXiv:2405.21060]. Prefill uses the chunked SSD form: within a chunk an
attention-like quadratic over ``chunk_size`` positions, across chunks
the chunk-final states carried in order; decode is the O(1) recurrent
update, written in place into the layer's cache: ``state`` [B, h, p, n]
float32 and ``conv`` [B, conv_width - 1, conv_dim], the causal conv's
history, in the model dtype. A prefill folds every position it is given
into both, the bucket's pad tokens included, as the reference does.

Layout: in_proj → (z, x, B, C, dt); causal depthwise conv + SiLU over
(x, B, C); SSD; the D skip; gated RMSNorm; out_proj. ngroups = 1 (B and
C shared across heads).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import rms_norm
from repro_torch.models.rglru import causal_conv

Cache = Dict[str, torch.Tensor]


def ssm_dims(cfg: ModelConfig):
    """(d_inner, heads, head_dim, state_dim, conv_dim)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = s.num_heads or d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.state_dim
    return d_inner, n_heads, s.head_dim, s.state_dim, conv_dim


def init_a_log(shape, generator, device) -> torch.Tensor:
    """log(A) for A = 1 .. 16 over the heads, the last axis (no draw)."""
    return torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                    dtype=torch.float32,
                                    device=device)).expand(shape).clone()


def init_dt_bias(shape, generator, device) -> torch.Tensor:
    """softplus⁻¹(dt) for dt log-uniform in [1e-3, 1e-1]."""
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(shape, generator=generator, device=device)
    return torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u)))


def init_ones(shape, generator, device) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


def ssm_param_shapes(cfg: ModelConfig):
    """name → (shape, init, fan_in, float32?), as
    :func:`~repro_torch.models.rglru.rglru_param_shapes`."""
    d = cfg.d_model
    di, h, p, n, conv_dim = ssm_dims(cfg)
    K = cfg.ssm.conv_width
    return {
        "in_proj": ((d, 2 * di + 2 * n + h), "dense", d, False),
        "conv_w": ((K, conv_dim), "dense", K, False),
        "conv_b": ((conv_dim,), "zeros", 0, False),
        "a_log": ((h,), init_a_log, 0, True),
        "d_skip": ((h,), init_ones, 0, True),
        "dt_bias": ((h,), init_dt_bias, 0, True),
        "norm": ((di,), "zeros", 0, True),
        "out_proj": ((di, d), "dense", di, False),
    }


def ssm_cache_spec(cfg: ModelConfig, batch: int, dtype):
    """name → (shape, dtype)."""
    di, h, p, n, conv_dim = ssm_dims(cfg)
    return {"state": ((batch, h, p, n), torch.float32),
            "conv": ((batch, cfg.ssm.conv_width - 1, conv_dim), dtype)}


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., Q] → [..., Q, Q] with out[..., i, j] = sum(a[j+1..i]) for
    i >= j, -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def _ssd_chunked(xh, a, B, C, chunk: int):
    """SSD over a whole sequence: xh [b, S, h, p] (dt-scaled input), a
    [b, S, h] (log decay per step), B and C [b, S, n], all float32 →
    (y [b, S, h, p], final state [b, h, p, n])."""
    b, S, h, p = xh.shape
    n = B.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    assert S % Q == 0, "sequence must be divisible by ssm chunk"
    xh = xh.reshape(b, nc, Q, h, p)
    a = a.reshape(b, nc, Q, h).permute(0, 1, 3, 2)          # [b,nc,h,Q]
    B_ = B.reshape(b, nc, Q, n)
    C_ = C.reshape(b, nc, Q, n)

    # 1. within each chunk (attention-like)
    L = torch.exp(_segsum(a))                               # [b,nc,h,Q,Q]
    L = torch.where(torch.isfinite(L), L, torch.zeros_like(L))
    scores = torch.einsum("bcqn,bcpn->bcqp", C_, B_)        # [b,nc,Q,Q]
    y_diag = torch.einsum("bcqp,bchqp,bcphd->bcqhd", scores, L, xh)

    # 2. each chunk's final state
    a_cum = torch.cumsum(a, dim=-1)                         # [b,nc,h,Q]
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)
    states = torch.einsum("bcqn,bchq,bcqhd->bchdn", B_, decay_to_end, xh)

    # 3. the states carried across chunks, in order
    chunk_decay = torch.exp(a_cum[..., -1])                 # [b,nc,h]
    carry = torch.zeros((b, h, p, n), dtype=xh.dtype, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(carry)                                  # before chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # [b,nc,h,p,n]

    # 4. the carried states' contribution
    y_off = torch.einsum("bcqn,bchq,bchdn->bcqhd", C_, torch.exp(a_cum),
                         prev_states)
    return (y_diag + y_off).reshape(b, S, h, p), carry


def ssm_apply(params, x, *, cfg: ModelConfig, mode: str,
              cache: Optional[Cache] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x [B, S, d] → (y [B, S, d], cache). ``prefill`` returns a fresh
    cache, ``train`` none; ``decode`` (S = 1) updates ``cache`` in
    place."""
    di, h, p, n, conv_dim = ssm_dims(cfg)
    Bsz, S, _ = x.shape
    if mode not in ("prefill", "train", "decode"):
        raise ValueError(f"ssm_apply: unsupported mode {mode!r}")
    proj = torch.einsum("bsd,de->bse", x, params["in_proj"])
    z, xr, Bc, Cc, dt = torch.split(proj, [di, di, n, n, h], dim=-1)
    hist = cache["conv"] if mode == "decode" else None
    conv_out, new_hist = causal_conv(torch.cat([xr, Bc, Cc], dim=-1),
                                     params["conv_w"], params["conv_b"], hist)
    xr, Bc, Cc = torch.split(F.silu(conv_out), [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])          # [B,S,h]
    A = -torch.exp(params["a_log"])                          # [h]
    a_log_step = dt * A                                      # [B,S,h]
    xh = xr.reshape(Bsz, S, h, p).float() * dt[..., None]

    if mode == "decode":
        decay = torch.exp(a_log_step[:, 0])                  # [B,h]
        st = (cache["state"] * decay[..., None, None]
              + torch.einsum("bhd,bn->bhdn", xh[:, 0], Bc[:, 0].float()))
        y = torch.einsum("bn,bhdn->bhd", Cc[:, 0].float(), st)[:, None]
        cache["state"].copy_(st)
        cache["conv"].copy_(new_hist)
        new_cache = cache
    else:
        y, final = _ssd_chunked(xh, a_log_step, Bc.float(), Cc.float(),
                                cfg.ssm.chunk_size)
        new_cache = ({"state": final, "conv": new_hist.contiguous()}
                     if mode == "prefill" else None)

    # the D skip, on the conv output before the dt scaling
    y = y + xr.reshape(Bsz, S, h, p).float() * params["d_skip"][:, None]
    y = y.reshape(Bsz, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), params["norm"],
                 cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y, params["out_proj"]), new_cache
