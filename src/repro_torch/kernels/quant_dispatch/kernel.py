"""ctypes wrapper of ``csrc/quant_dispatch.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    fn = runtime.library("quant_dispatch").quant_dispatch_launch
    fn.argtypes = [_P, _I, _I, _I, _P, _P, _P]
    fn.restype = _I
    return fn


def quant_dispatch_cuda(x: torch.Tensor):
    """x [T, d] bf16/f32 → (int8 [T, d], f32 scales [T]), one scale per
    row, bit-identical to :func:`quant_dispatch_ref`."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"quant_dispatch: dtype {x.dtype} unsupported")
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"quant_dispatch: x must be [T, d > 0], got "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    runtime.require_cuda("quant_dispatch", x)
    T, d = x.shape
    q = torch.empty((T, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((T,), dtype=torch.float32, device=x.device)
    if T:
        status = _fn()(x.data_ptr(), _DTYPES[x.dtype], T, d, q.data_ptr(),
                       scales.data_ptr(), runtime.stream_handle(x))
        runtime.check_status("quant_dispatch", status)
        runtime.count_launch("quant_dispatch")
    return q, scales
