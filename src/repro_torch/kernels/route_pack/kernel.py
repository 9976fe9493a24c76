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
_ID_BYTES = {torch.int32: 4, torch.int64: 8}
MAX_COUNT = 8192          # RP_MAX_COUNT in the source


@functools.cache
def _fn():
    fn = runtime.library("route_pack").route_pack_launch
    fn.argtypes = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P, _P, _I, _I, _P, _P]
    fn.restype = _I
    return fn


def _int32(t):
    """``t`` as contiguous int32, converted only when it is not already."""
    if t is None or (t.dtype == torch.int32 and t.is_contiguous()):
        return t
    return t.to(torch.int32).contiguous()


def route_pack_cuda(x, dest, valid, eid, *, k: int, n_dest: int,
                    capacity: int, quantize: bool, count_ids=None,
                    n_count: int = 0) -> RoutePack:
    """Launch the fused route-pack kernel. x [T, d] bf16/f32; dest/valid/
    eid [N = T*k] int32 (``valid``/``eid`` may be None); count_ids [N]
    int32/int64 or None: with them the same launch runs EPLB Collect in
    one more block, and the pack carries ``counts`` [n_count] int32. One
    launch, counted once as ``route_pack`` (and in ``runtime.FUSED`` as
    ``collect`` when it counts): the kernel writes every byte of every
    output, so they are allocated uninitialised."""
    T, d = x.shape
    N = dest.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"route_pack: payload dtype {x.dtype} unsupported")
    if N != T * k:
        raise ValueError(f"route_pack: N={N} != T*k={T * k}")
    if n_dest < 1 or capacity < 1:
        raise ValueError(f"route_pack: n_dest={n_dest}, capacity={capacity}")
    if count_ids is not None:
        if count_ids.dtype not in _ID_BYTES:
            raise TypeError(f"route_pack: count ids must be int32 or int64, "
                            f"got {count_ids.dtype}")
        if (tuple(count_ids.shape) != (N,)
                or not 0 < n_count <= MAX_COUNT):
            raise ValueError(f"route_pack: count ids "
                             f"{tuple(count_ids.shape)} for N={N}, "
                             f"n_count={n_count}")
        count_ids = count_ids.contiguous()
    dev = x.device
    dest, valid, eid_t = _int32(dest), _int32(valid), _int32(eid)
    x = x.contiguous()
    runtime.require_cuda("route_pack", x, dest,
                         *(t for t in (valid, eid_t, count_ids)
                           if t is not None))
    out_dtype = torch.int8 if quantize else x.dtype
    buckets = torch.empty((n_dest, capacity, d), dtype=out_dtype, device=dev)
    scales = (torch.empty((n_dest, capacity), dtype=torch.float32, device=dev)
              if quantize else None)
    eids = (torch.empty((n_dest, capacity), dtype=torch.int32, device=dev)
            if eid_t is not None else None)
    rank = torch.empty((N,), dtype=torch.int32, device=dev)
    keep = torch.empty((N,), dtype=torch.bool, device=dev)
    counts = (torch.empty((n_count,), dtype=torch.int32, device=dev)
              if count_ids is not None else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = _fn()(ptr(x), _DTYPES[x.dtype], ptr(dest), ptr(valid),
                   ptr(eid_t), d, N, k, n_dest, capacity, int(quantize),
                   ptr(buckets), ptr(scales), ptr(eids), ptr(rank),
                   ptr(keep), ptr(count_ids),
                   0 if count_ids is None else _ID_BYTES[count_ids.dtype],
                   n_count, ptr(counts), runtime.stream_handle(x))
    runtime.check_status("route_pack", status)
    runtime.count_launch("route_pack")
    if counts is not None:
        runtime.count_fused("collect")
    return RoutePack(buckets, scales, eids, rank, keep, counts)
