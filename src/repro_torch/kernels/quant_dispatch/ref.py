"""Plain PyTorch version of token-wise INT8 quantization.

The formula of the JAX package's ``quant_dispatch_ref`` (and of its
``quantize_act_tokenwise`` and ``quantize_kv_entry``) step for step in
float32: ``scale = max(amax, 1e-8) / 127``, ``q = clip(round(x / scale),
-127, 127)`` with true divides (on the CPU and on the card alike) and
half-to-even rounding.
"""
from __future__ import annotations

import torch


def quant_dispatch_ref(x: torch.Tensor):
    """x [T, d] → (int8 [T, d], f32 scales [T])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on the card PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, one ulp off the true divide in some rows
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]
