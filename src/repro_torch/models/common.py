"""Shared building blocks: devices, initializers, norms, RoPE, attention."""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (every entry point's
    default) requires a card: without one this raises rather than
    carrying on on the CPU, which runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts and tuples (a
    NamedTuple is a leaf) — parameters, caches and their specs."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def microbatch_sizes(n: int, mb: int) -> Tuple[int, ...]:
    """Split ``n`` rows into ``mb`` contiguous §4.4 ping-pong
    micro-batches (earlier chunks take the remainder)."""
    mb = max(1, min(int(mb), n)) if n else 1
    return tuple(n // mb + (1 if i < n % mb else 0) for i in range(mb))


# ---------------------------------------------------------------------------
# Initializers (same distributions as the JAX package, not the same draws).
# Filled in flat slices so float32 temporaries stay small even for
# DeepSeek-V3's [256, 7168, 2048] expert stacks.
# ---------------------------------------------------------------------------
_FILL_ELEMS = 1 << 26


def _fill_(out: torch.Tensor, draw) -> None:
    """Fill ``out`` (contiguous) in flat slices with ``draw(shape)``."""
    flat = out.view(-1)
    for i in range(0, flat.numel(), _FILL_ELEMS):
        part = flat[i:i + _FILL_ELEMS]
        part.copy_(draw(part.shape))


def dense_init(shape: Sequence[int], dtype, fan_in: int,
               generator: torch.Generator, device) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, ``std = 1/sqrt(fan_in)``,
    by inverting the normal CDF over uniform draws."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    scale = 1.0 / math.sqrt(max(fan_in, 1))

    def draw(shape):
        u = torch.rand(shape, generator=generator, device=out.device)
        z = torch.erfinv(lo + (hi - lo) * u) * math.sqrt(2.0)
        return torch.clamp(z, -2.0, 2.0) * scale
    _fill_(out, draw)
    return out


def embed_init(shape: Sequence[int], dtype, generator: torch.Generator,
               device) -> torch.Tensor:
    """Normal init with std 0.02."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    _fill_(out, lambda shape: torch.randn(
        shape, generator=generator, device=out.device) * 0.02)
    return out


# ---------------------------------------------------------------------------
# RMSNorm (scale stored as a deviation from 1.0, computed in f32)
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (f64 frequencies, split halves)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions broadcastable to
    [..., seq]."""
    head_dim = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(head_dim, theta),
                            dtype=torch.float32, device=x.device)
    angles = positions[..., None].float() * freqs       # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Reference attention (materializes scores; f32 scores and accumulation)
# ---------------------------------------------------------------------------
def naive_attention(q, k, v, *, causal: bool = True,
                    kv_positions: Optional[torch.Tensor] = None,
                    q_positions: Optional[torch.Tensor] = None):
    """q [B, Sq, H, hd]; k/v [B, Sk, KV, hd] → [B, Sq, H, vd]."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qr = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bpkd->bkgqp", qr.float(), k.float()) * scale
    if causal:
        qp = (q_positions if q_positions is not None
              else torch.arange(Sq, device=q.device))
        kp = (kv_positions if kv_positions is not None
              else torch.arange(k.shape[1], device=q.device))
        msk = qp[:, None] >= kp[None, :]
        s = s.masked_fill(~msk, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqp,bpkd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
