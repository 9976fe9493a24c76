"""ctypes wrapper of ``csrc/route_pack.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.route_pack.ref import RoutePack

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    fn = runtime.library("route_pack").route_pack_launch
    fn.argtypes = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P]
    fn.restype = _I
    return fn


def _int32(t):
    """``t`` as contiguous int32, converted only when it is not already."""
    if t is None or (t.dtype == torch.int32 and t.is_contiguous()):
        return t
    return t.to(torch.int32).contiguous()


def route_pack_cuda(x, dest, valid, eid, *, k: int, n_dest: int,
                    capacity: int, quantize: bool) -> RoutePack:
    """Launch the fused route-pack kernel. x [T, d] bf16/f32; dest/valid/
    eid [N = T*k] int32 (``valid``/``eid`` may be None). One launch: the
    kernel writes every byte of every output, so they are allocated
    uninitialised."""
    T, d = x.shape
    N = dest.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"route_pack: payload dtype {x.dtype} unsupported")
    if N != T * k:
        raise ValueError(f"route_pack: N={N} != T*k={T * k}")
    if n_dest < 1 or capacity < 1:
        raise ValueError(f"route_pack: n_dest={n_dest}, capacity={capacity}")
    dev = x.device
    dest, valid, eid_t = _int32(dest), _int32(valid), _int32(eid)
    x = x.contiguous()
    runtime.require_cuda("route_pack", x, dest,
                         *(t for t in (valid, eid_t) if t is not None))
    out_dtype = torch.int8 if quantize else x.dtype
    buckets = torch.empty((n_dest, capacity, d), dtype=out_dtype, device=dev)
    scales = (torch.empty((n_dest, capacity), dtype=torch.float32, device=dev)
              if quantize else None)
    eids = (torch.empty((n_dest, capacity), dtype=torch.int32, device=dev)
            if eid_t is not None else None)
    rank = torch.empty((N,), dtype=torch.int32, device=dev)
    keep = torch.empty((N,), dtype=torch.bool, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = _fn()(ptr(x), _DTYPES[x.dtype], ptr(dest), ptr(valid),
                   ptr(eid_t), d, N, k, n_dest, capacity, int(quantize),
                   ptr(buckets), ptr(scales), ptr(eids), ptr(rank),
                   ptr(keep), runtime.stream_handle(x))
    runtime.check_status("route_pack", status)
    runtime.count_launch("route_pack")
    return RoutePack(buckets, scales, eids, rank, keep)
