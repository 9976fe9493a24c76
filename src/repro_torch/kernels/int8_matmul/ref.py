"""Plain PyTorch version of the W8A8 INT8 matrix product.

``acc = x_q @ w_q`` exactly, then ``acc * x_scale[:, None] *
w_scale[None, :]`` in float32, left to right, as the JAX package's
``int8_matmul_ref``. PyTorch has no general integer product for CUDA
tensors, so the sum is taken in float64, where it is exact: every
product and partial sum is an integer of magnitude at most ``127² K <
2⁵³``. The exact integer then rounds to float32 once, as the int32
accumulator does.
"""
from __future__ import annotations

import torch


def int8_matmul_ref(x_q, x_scale, w_q, w_scale):
    """x_q [M, K] int8, x_scale [M] f32 (token-wise), w_q [K, N] int8,
    w_scale [N] f32 (channel-wise) → [M, N] f32."""
    acc = torch.matmul(x_q.double(), w_q.double())
    return acc.float() * x_scale[:, None] * w_scale[None, :]
