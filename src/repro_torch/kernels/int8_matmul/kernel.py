"""ctypes wrapper of ``csrc/int8_matmul.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
#: largest depth whose int32 sums are exact: 127² · K < 2³¹
MAX_K = 133143


@functools.cache
def _fn():
    fn = runtime.library("int8_matmul").int8_matmul_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def int8_matmul_cuda(x_q, x_scale, w_q, w_scale):
    """x_q [M, K] int8, x_scale [M] f32, w_q [K, N] int8 (the reference's
    layout, read in place), w_scale [N] f32 → [M, N] f32, bit-identical
    to :func:`int8_matmul_ref`. Any M, K ≤ 133143 and N."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("int8_matmul: x_q and w_q must be int8")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError("int8_matmul: scales must be float32")
    if x_q.dim() != 2 or w_q.dim() != 2:
        raise ValueError("int8_matmul: x_q and w_q must be 2-D")
    M, K = x_q.shape
    Kw, N = w_q.shape
    if (Kw != K or tuple(x_scale.shape) != (M,)
            or tuple(w_scale.shape) != (N,) or 0 in (M, K, N)):
        raise ValueError(f"int8_matmul: shapes x_q {tuple(x_q.shape)}, "
                         f"x_scale {tuple(x_scale.shape)}, w_q "
                         f"{tuple(w_q.shape)}, w_scale "
                         f"{tuple(w_scale.shape)}")
    if K > MAX_K:
        raise ValueError(f"int8_matmul: K={K} > {MAX_K}: the int32 sums "
                         f"could overflow")
    x_q, w_q = x_q.contiguous(), w_q.contiguous()
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    runtime.require_cuda("int8_matmul", x_q, x_scale, w_q, w_scale)
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    vec = (K % 16 == 0 and N % 16 == 0
           and all(t.data_ptr() % 16 == 0 for t in (x_q, w_q, out)))
    status = _fn()(x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(),
                   w_scale.data_ptr(), out.data_ptr(), M, N, K, int(vec),
                   runtime.stream_handle(x_q))
    runtime.check_status("int8_matmul", status)
    runtime.count_launch("int8_matmul")
    return out
