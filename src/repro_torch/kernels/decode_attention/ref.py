"""Plain PyTorch version of GQA decode attention over a KV cache.

Written in the unnormalised form the JAX package's model uses on one
device (``_local_partial_attention`` followed by ``acc / max(l,
1e-30)``): scores in float32, the max of each row guarded so that a
fully masked row gives zeros, ``p`` cast to the value type before the
``p·v`` product, float32 accumulation; a masked cache slot counts as
zeros, whatever it holds. The CPU model path runs this, so it rounds the
way the reference model does.
"""
from __future__ import annotations

import numpy as np
import torch


def valid_slots(positions: torch.Tensor, L: int,
                window: int = 0) -> torch.Tensor:
    """[B, L] bool: which cache slots hold a position the new token at
    ``positions[b]`` attends to. ``window == 0``: slot ``s`` holds
    position ``s``. ``window > 0``: a ring buffer, slot ``s`` holds the
    latest position ``p ≡ s (mod window)`` with ``p ≤ pos``."""
    pos = positions.long()[:, None]
    slots = torch.arange(L, device=positions.device)[None, :]
    if window > 0:
        kv_pos = pos - torch.remainder(pos - slots, window)
        return (kv_pos >= 0) & (kv_pos > pos - window) & (kv_pos <= pos)
    return slots <= pos


def decode_attention_ref(q, k, v, positions, *, window: int = 0):
    """q [B, H, hd]; k/v [B, L, KV, hd]; positions [B] int (the new
    token's position) → [B, H, vd] float32."""
    B, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qr = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,blkd->bkgl", qr, k.float()) * scale
    valid = valid_slots(positions, L, window)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - safe_m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    # a masked slot counts as zeros whatever it holds (a NaN in a stale
    # slot times p = 0 would be NaN)
    v = torch.where(valid[:, :, None, None], v, torch.zeros((), dtype=v.dtype))
    acc = torch.einsum("bkgl,blkd->bkgd", p.to(v.dtype).float(), v.float())
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, v.shape[-1])
