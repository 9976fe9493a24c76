"""ctypes wrapper of ``csrc/collect.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
_ID_BYTES = {torch.int32: 4, torch.int64: 8}
_MAX_E = 12288            # CO_MAX_E in the source


@functools.cache
def _fn():
    fn = runtime.library("collect").collect_launch
    fn.argtypes = [_P, _I, _I, _I, _P, _P]
    fn.restype = _I
    return fn


def collect_cuda(expert_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """expert_ids [N] int32/int64 → counts [n_experts] int32; ids outside
    ``[0, n_experts)`` are ignored."""
    if expert_ids.dtype not in _ID_BYTES:
        raise TypeError(f"collect: ids must be int32 or int64, got "
                        f"{expert_ids.dtype}")
    if expert_ids.dim() != 1 or not 0 < n_experts <= _MAX_E:
        raise ValueError(f"collect: ids {tuple(expert_ids.shape)}, "
                         f"n_experts {n_experts}")
    ids = expert_ids.contiguous()
    runtime.require_cuda("collect", ids)
    counts = torch.empty((n_experts,), dtype=torch.int32, device=ids.device)
    status = _fn()(ids.data_ptr(), _ID_BYTES[ids.dtype], ids.shape[0],
                   n_experts, counts.data_ptr(), runtime.stream_handle(ids))
    runtime.check_status("collect", status)
    runtime.count_launch("collect")
    return counts
