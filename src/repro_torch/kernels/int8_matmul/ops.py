"""W8A8 INT8 matrix product entry point.

:func:`quantized_matmul` launches the hand-written CUDA kernel for
tensors on the card and takes the plain version (``ref.py``) only for
tensors on the CPU; any other device raises, and a failed build or
launch on the card raises — there is no fallback. Ragged shapes run in
the kernel as they are: nothing is padded.
"""
from __future__ import annotations

from repro_torch.kernels.int8_matmul.kernel import int8_matmul_cuda
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref


def quantized_matmul(x_q, x_scale, w_q, w_scale):
    """x_q [M, K] int8, x_scale [M] f32, w_q [K, N] int8, w_scale [N] f32
    → [M, N] f32."""
    if x_q.device.type == "cuda":
        return int8_matmul_cuda(x_q, x_scale, w_q, w_scale)
    if x_q.device.type == "cpu":
        return int8_matmul_ref(x_q, x_scale, w_q, w_scale)
    raise ValueError(f"int8_matmul: no kernel for device {x_q.device}")
