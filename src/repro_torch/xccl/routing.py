"""XCCL's token-wise INT8 wire format (§3.2 step 2, §4.7 "communication
quantization"): quantize before the wire, dequantize after.

The disaggregated MoE-Attention driver packs its A2E payload through
route-pack's INT8 branch, which applies :func:`quantize_tokens`'s formula
inside the kernel, and the expert side reads it back through
:func:`dequantize_tokens`. Both are plain tensor code on any device.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-wise INT8: x [..., d] → (int8 values, f32 scale per token),
    ``scale = max(amax, 1e-8) · (1/127)``, then round-half-to-even of a
    true divide by the scale, clipped to ±127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0]


def dequantize_tokens(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(int8 values [..., d], f32 scales [...]) → f32 [..., d]."""
    return q.float() * scale[..., None]
