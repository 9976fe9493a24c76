"""Token-wise INT8 quantization entry point.

:func:`fused_quantize` launches the hand-written CUDA kernel for a tensor
on the card and takes the plain version (``ref.py``) only for a tensor on
the CPU; any other device raises, and a failed build or launch on the
card raises — there is no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.quant_dispatch.kernel import quant_dispatch_cuda
from repro_torch.kernels.quant_dispatch.ref import quant_dispatch_ref


def fused_quantize(x):
    """x [T, d] bf16/f32 → (int8 [T, d], f32 scales [T])."""
    if x.device.type == "cuda":
        return quant_dispatch_cuda(x)
    if x.device.type == "cpu":
        return quant_dispatch_ref(x)
    raise ValueError(f"quant_dispatch: no kernel for device {x.device}")
