"""ctypes wrapper of ``csrc/gmm.cu`` (CUDA tensors only).

One C entry serves both TPU kernels it replaces: ``phys_owner=None`` is
the plain grouped FFN (``gmm``), a ``[S]`` int32 owner table the
owner-indexed ``placement_gmm``. Each counts its own launches.
"""
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
    fn = runtime.library("gmm").gmm_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def gmm_cuda(buckets, we_gate, we_up, we_down, phys_owner=None):
    """buckets [S, C, d]; we_gate/we_up [E, d, f]; we_down [E, f, d], all
    of one dtype (bf16 or f32); phys_owner [S] int32 or None (then
    S == E). Returns [S, C, d] f32. Owner ids must lie in [0, E): the
    kernel traps otherwise."""
    S, C, d = buckets.shape
    E, d2, f = we_gate.shape
    dtype = buckets.dtype
    if dtype not in _DTYPES or any(w.dtype != dtype
                                   for w in (we_gate, we_up, we_down)):
        raise TypeError("gmm: buckets and weights must share one dtype "
                        f"in {list(_DTYPES)}")
    if (d2 != d or tuple(we_up.shape) != (E, d, f)
            or tuple(we_down.shape) != (E, f, d) or d % 2 or f % 2):
        raise ValueError(f"gmm: shapes {tuple(buckets.shape)}, "
                         f"{tuple(we_gate.shape)}, {tuple(we_down.shape)}")
    if phys_owner is None:
        if S != E:
            raise ValueError(f"gmm: {S} buckets for {E} experts")
        name, owner = "gmm", None
    else:
        if tuple(phys_owner.shape) != (S,):
            raise ValueError(f"placement_gmm: owner shape "
                             f"{tuple(phys_owner.shape)} for {S} slots")
        name, owner = "placement_gmm", phys_owner.to(torch.int32).contiguous()
    buckets = buckets.contiguous()
    runtime.require_cuda(name, buckets, we_gate, we_up, we_down,
                         *(() if owner is None else (owner,)))
    dev = buckets.device
    hidden = torch.empty((S, C, f), dtype=dtype, device=dev)
    out = torch.empty((S, C, d), dtype=torch.float32, device=dev)
    status = _fn()(buckets.data_ptr(), we_gate.data_ptr(), we_up.data_ptr(),
                   we_down.data_ptr(),
                   None if owner is None else owner.data_ptr(),
                   hidden.data_ptr(), out.data_ptr(), S, C, d, f, E,
                   _DTYPES[dtype], runtime.stream_handle(buckets))
    runtime.check_status(name, status)
    runtime.count_launch(name)
    return out
