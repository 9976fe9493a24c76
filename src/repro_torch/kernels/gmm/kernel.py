"""ctypes wrapper of ``csrc/gmm.cu`` (CUDA tensors only).

One C entry serves both TPU kernels it replaces: ``phys_owner=None`` is
the plain grouped FFN (``gmm``), a ``[S]`` int32 owner table the
owner-indexed ``placement_gmm``. Each counts its own launches. The call
also computes, on the card, each slot's live rows (``ref.live_rows``),
which :func:`gmm_cuda_with_rows` returns beside the output. The C entry
chooses its variant and tiles from the shapes alone; :func:`plan`
mirrors that choice.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: what each variant's vector loads take: d and f a multiple of the first,
#: every tensor aligned to the second (bytes)
_ALIGN = {torch.float32: (2, 8), torch.bfloat16: (8, 16)}


#: bf16 capacities up to this take the 8-row mma.sync tile (``tc_pass``),
#: larger ones the wgmma variant (``wg_pass``)
MMA_MAX_C = 8
#: the wgmma variant's staged rows (its N): C rounded up to one of these
WG_WIDTHS = (16, 32, 64, 128)
WG_ROWS = 128           # WG_RT: bucket rows of a wgmma row tile
_BN = 128               # TC_BN: output columns of an item
_BK = 64                # TC_BK / WG_BK: reduction rows of a bf16 stage
_WG_RING = 200 * 1024   # WG_RING: shared memory of the wgmma ring
_F32_ROWS, _F32_KCHUNK = 8, 256


class Plan(NamedTuple):
    """How :func:`gmm_cuda` runs a call. ``variant``: ``f32`` (CUDA-core
    FMAs), ``mma`` (bf16 C <= 8, mma.sync) or ``wgmma`` (bf16 C > 8);
    ``rows``, the bucket rows of a row tile, and ``row_tiles`` of them a
    slot; ``nb``, the rows staged and computed for each tile (8, or the
    wgmma width); then for (pass 1, pass 2): the column tiles of
    ``_BN``, the reduction steps, the bytes of one stage of the
    shared-memory ring (f32: its staged chunk of rows) and the stages."""
    variant: str
    rows: int
    row_tiles: int
    nb: int
    col_tiles: tuple
    k_steps: tuple
    stage_bytes: tuple
    stages: tuple


def plan(S: int, C: int, d: int, f: int, dtype) -> Plan:
    """The variant and tiles of an ``[S, C, d] x [d, f]`` call, a function
    of (C, d, f, dtype) alone, as ``gmm_launch`` chooses them (``S``, the
    slot count, changes only how many items there are)."""
    del S
    cols = (-(-f // _BN), -(-d // _BN))
    if dtype == torch.float32:
        ks = (-(-d // _F32_KCHUNK), -(-f // _F32_KCHUNK))
        chunk = _F32_ROWS * _F32_KCHUNK * 4
        return Plan("f32", _F32_ROWS, -(-C // _F32_ROWS), _F32_ROWS, cols,
                    ks, (chunk, chunk), (1, 1))
    ks = (-(-d // _BK), -(-f // _BK))
    weights = (2 * _BK * _BN * 2, _BK * _BN * 2)       # gate and up / down
    if C <= MMA_MAX_C:
        rows = 8 * (_BK * 2 + 16)                      # padded by 16 bytes
        return Plan("mma", 8, 1, 8, cols, ks,
                    tuple(w + rows for w in weights), (4, 4))
    nb = next(w for w in WG_WIDTHS if w >= min(C, WG_ROWS))
    stage = tuple(w + nb * _BK * 2 for w in weights)
    return Plan("wgmma", WG_ROWS, -(-C // WG_ROWS), nb, cols, ks, stage,
                tuple(min(8, _WG_RING // s) for s in stage))


@functools.cache
def _fn():
    fn = runtime.library("gmm").gmm_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _P]
    fn.restype = _I
    return fn


def gmm_cuda(buckets, we_gate, we_up, we_down, phys_owner=None):
    """buckets [S, C, d]; we_gate/we_up [E, d, f]; we_down [E, f, d], all
    of one dtype (bf16 or f32); phys_owner [S] int32 or None (then
    S == E). Returns [S, C, d] f32. Owner ids must lie in [0, E): the
    kernel traps otherwise."""
    return gmm_cuda_with_rows(buckets, we_gate, we_up, we_down,
                              phys_owner)[0]


def gmm_cuda_with_rows(buckets, we_gate, we_up, we_down, phys_owner=None):
    """:func:`gmm_cuda`, returning ``(out, rows)``: ``rows`` [S] int32 is
    what the kernel's prologue computed on the card, the number of
    leading rows of each slot it ran (``ref.live_rows``). bf16 takes d
    and f multiples of 8 and 16-byte aligned tensors; f32 d and f even."""
    runtime.refuse_grad("gmm", buckets, we_gate, we_up, we_down)
    S, C, d = buckets.shape
    E, d2, f = we_gate.shape
    dtype = buckets.dtype
    if dtype not in _DTYPES or any(w.dtype != dtype
                                   for w in (we_gate, we_up, we_down)):
        raise TypeError("gmm: buckets and weights must share one dtype "
                        f"in {list(_DTYPES)}")
    align, align_bytes = _ALIGN[dtype]
    if (d2 != d or tuple(we_up.shape) != (E, d, f)
            or tuple(we_down.shape) != (E, f, d) or d % align or f % align):
        raise ValueError(f"gmm: shapes {tuple(buckets.shape)}, "
                         f"{tuple(we_gate.shape)}, {tuple(we_down.shape)} "
                         f"({dtype} takes d and f multiples of {align})")
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
    if any(t.data_ptr() % align_bytes
           for t in (buckets, we_gate, we_up, we_down)):
        raise ValueError(f"{name}: {dtype} tensors must be "
                         f"{align_bytes}-byte aligned")
    dev = buckets.device
    hidden = torch.empty((S, C, f), dtype=dtype, device=dev)
    out = torch.empty((S, C, d), dtype=torch.float32, device=dev)
    work = torch.empty(S + 1 + S * C, dtype=torch.int32, device=dev)
    status = _fn()(buckets.data_ptr(), we_gate.data_ptr(), we_up.data_ptr(),
                   we_down.data_ptr(),
                   None if owner is None else owner.data_ptr(),
                   hidden.data_ptr(), out.data_ptr(), work.data_ptr(),
                   S, C, d, f, E, _DTYPES[dtype],
                   runtime.stream_handle(buckets))
    runtime.check_status(name, status)
    runtime.count_launch(name)
    return out, work[:S]
