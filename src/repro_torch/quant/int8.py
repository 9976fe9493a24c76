"""INT8 quantization core (§4.7).

The paper deploys DeepSeek-class models in INT8 by post-training
quantization: token-wise activation scales (one per token), channel-wise
weight scales (one per output channel), and a hardware INT8 matmul
(``npu_quant_matmul``). Here the activations go through the
quant-dispatch kernel and the product through the INT8-matmul kernel on
the card (their plain versions on the CPU).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.int8_matmul.ops import quantized_matmul
from repro_torch.kernels.int8_matmul.ref import (
    int8_matmul_ref as _int8_matmul_ref)
from repro_torch.kernels.quant_dispatch.ops import fused_quantize


@dataclasses.dataclass
class QTensor:
    """Channel-wise quantized weight: values int8 [in, out], scale f32
    [out] (one per output channel).

    ``values`` is stored K-major: the [in, out] view of an [out, in]
    row-major tensor (for stacked expert weights [E, in, out], of
    [E, out, in]), made once here, whatever layout it was given in. The
    INT8-matmul kernel reads the weight in that layout, the one the card's
    8-bit tensor-core instructions take; shape and values are those
    given, and no second copy is kept."""
    values: torch.Tensor
    scale: torch.Tensor

    def __post_init__(self):
        if self.values.dim() >= 2:
            kmajor = self.values.transpose(-1, -2)
            if not kmajor.is_contiguous():
                kmajor = kmajor.contiguous()
            self.values = kmajor.transpose(-1, -2)

    @property
    def shape(self):
        return self.values.shape

    def dequantize(self) -> torch.Tensor:
        return self.values.float() * self.scale


def quantize_weight_channelwise(w: torch.Tensor, axis: int = -1) -> QTensor:
    """w [..., out] → int8 with per-output-channel scales. An N-D weight
    is reduced over every axis but ``axis``: stacked expert weights share
    one scale per output channel across experts."""
    wf = w.float()
    reduce_axes = tuple(i for i in range(w.dim()) if i != axis % w.dim())
    # (an empty dim tuple would make amax reduce over every axis)
    amax = (wf.abs().amax(dim=reduce_axes, keepdim=True) if reduce_axes
            else wf.abs())
    # a tensor divisor, so that the card divides as the CPU does (PyTorch's
    # CUDA division by a Python scalar multiplies by its reciprocal)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale.reshape(scale.shape[axis % w.dim()]))


def quantize_act_tokenwise(x: torch.Tensor):
    """x [..., d] → (int8 [..., d], f32 scale per token row [...])."""
    q, s = fused_quantize(x.reshape(-1, x.shape[-1]))
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def int8_matmul_ref(x_q: torch.Tensor, x_scale: torch.Tensor,
                    w: QTensor) -> torch.Tensor:
    """(token-wise int8 x) @ (channel-wise int8 w), exact sums, rescaled
    to f32 — the plain version of the INT8-matmul kernel."""
    return _int8_matmul_ref(x_q, x_scale, w.values, w.scale)


def quantized_linear(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """The W8A8 linear: quantize the activations token-wise, INT8
    product, rescale. x [..., in] → [..., out] f32."""
    shape = x.shape[:-1]
    xq, xs = fused_quantize(x.reshape(-1, x.shape[-1]))
    y = quantized_matmul(xq, xs, w.values, w.scale)
    return y.reshape(*shape, -1)


def quantization_error(w: torch.Tensor, q: QTensor) -> float:
    """Relative Frobenius error of a quantized weight."""
    wf = w.float()
    d = wf - q.dequantize().reshape(w.shape)
    return float(torch.linalg.norm(d)
                 / torch.clamp(torch.linalg.norm(wf), min=1e-9))
