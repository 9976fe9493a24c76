"""ctypes wrapper of ``csrc/gmm.cu`` (CUDA tensors only).

One C entry serves both TPU kernels it replaces: ``phys_owner=None`` is
the plain grouped FFN (``gmm``), a ``[S]`` int32 owner table the
owner-indexed ``placement_gmm``. Each counts its own launches. The call
also computes, on the card, each slot's live rows (``ref.live_rows``),
which :func:`gmm_cuda_with_rows` returns beside the output. The C entry
chooses its tiles from the shapes alone (bf16: one ``wgmma`` variant,
``wg_pass``, at 8, 16, 32, 64 or 128 staged rows; at C <= 8 an 8-row
tile and a K split fixed by (d, f); float32: CUDA-core
FMAs); :func:`plan` mirrors that choice and :func:`work_ints` the size
of its work buffer.
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


#: the bf16 variant's staged rows (wgmma's N): C rounded up to one of these
WG_WIDTHS = (8, 16, 32, 64, 128)
#: bf16 capacities up to this take one 8-row tile a slot and the K split
#: (``WG_NARROW``)
NARROW_C = 8
WG_ROWS = 128           # WG_RT: bucket rows of a row tile above NARROW_C
WG_FILL = 132           # WG_FILL: (unit, K range) pieces of a C <= 8 pass
                        # at one live slot, at least where K allows
_BN = 128               # WG_BN: output columns of an item
_BK = 64                # WG_BK: reduction rows of a bf16 stage
_WG_RING = 200 * 1024   # WG_RING: shared memory of the wgmma ring
_F32_ROWS, _F32_KCHUNK = 8, 256


class Plan(NamedTuple):
    """How :func:`gmm_cuda` runs a call. ``variant``: ``f32`` (CUDA-core
    FMAs) or ``wgmma`` (bf16); ``rows``, the bucket rows of a row tile,
    and ``row_tiles`` of them a slot; ``nb``, the rows staged and
    computed for each tile (the wgmma width, or the f32 tile); then for
    (pass 1, pass 2): the column tiles of ``_BN``, the 64-deep (f32:
    256-deep) reduction steps, the K ranges an item's reduction is split
    into (C <= 8: ``split``), the bytes of one stage of the shared-memory
    ring (f32: its staged chunk of rows) and the stages."""
    variant: str
    rows: int
    row_tiles: int
    nb: int
    col_tiles: tuple
    k_steps: tuple
    splits: tuple
    stage_bytes: tuple
    stages: tuple


def piece_cost(U2: int, ns: int, nk: int, G: int, nw: int, L: int) -> int:
    """``wg_piece_cost``: the time, in 16 KB of weights at an SM's share
    of the bandwidth, of cutting ``U2`` leftover units of ``ns`` K ranges
    (``nk`` 64-deep steps, ``nw`` weight matrices) into pieces of ``L``
    ranges on ``G`` blocks: the most loaded block's pieces, each its
    steps plus a ticket (128 KB)."""
    pieces = U2 * -(-ns // L)
    return -(-pieces // G) * (nw * -(-L * nk // ns) + 8)


def split(N: int, K: int, nw: int) -> int:
    """``wg_split``: the K ranges of a C <= 8 pass with ``N`` output and
    ``K`` reduction columns and ``nw`` weight matrices. Ranges of two
    64-deep steps or more (where K has them), at least ``WG_FILL``
    (unit, range) pieces at one live slot; of those, the fewest ranges
    whose best piece length gives one live slot on ``WG_FILL`` SMs a
    time within 5% of the least."""
    nct, nk = -(-N // _BN), -(-K // _BK)
    top = max(1, nk // 2)
    best = {ns: min(piece_cost(nct, ns, nk, WG_FILL, nw, L)
                    for L in range(1, ns + 1))
            for ns in range(1, top + 1) if nct * ns >= WG_FILL}
    if not best:
        return top
    least = min(best.values())
    return min(ns for ns, c in best.items() if 20 * c <= 21 * least)


def piece_len(U2: int, ns: int, nk: int, G: int, nw: int) -> int:
    """``wg_piece_len``: the K ranges of a piece when ``U2`` units are
    left over after the whole rounds on ``G`` blocks (the least
    :func:`piece_cost`, the longest among equals)."""
    if U2 == 0:
        return ns
    return min(range(1, ns + 1),
               key=lambda L: (piece_cost(U2, ns, nk, G, nw, L), -L))


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
                    ks, (1, 1), (chunk, chunk), (1, 1))
    nb = next(w for w in WG_WIDTHS if w >= min(C, WG_ROWS))
    rows = NARROW_C if C <= NARROW_C else WG_ROWS
    splits = (split(f, d, 2), split(d, f, 1)) if C <= NARROW_C else (1, 1)
    stage = tuple(nw * _BK * _BN * 2 + nb * _BK * 2 for nw in (2, 1))
    return Plan("wgmma", rows, -(-C // rows), nb, cols,
                (-(-d // _BK), -(-f // _BK)), splits, stage,
                tuple(min(8, _WG_RING // s) for s in stage))


def work_ints(S: int, C: int, d: int, f: int, dtype,
              blocks: int = WG_FILL) -> int:
    """``gmm_work_ints`` on a card whose persistent grid has ``blocks``
    blocks: int32 entries of the call's work buffer — rows, pair count
    and pairs, then at C <= 8 in bf16 a ticket per (slot, column tile)
    and, from a 128-byte boundary, the float32 partial sums of the
    pieces, [NW][1024] for each of ``(blocks - 1) ns`` (the larger
    pass's: fewer than one unit a block is split into pieces)."""
    n = S + 1 + S * C
    if dtype != torch.bfloat16 or C > NARROW_C:
        return n
    p = plan(S, C, d, f, dtype)
    part = max((blocks - 1) * ns * nw * 1024 if ns > 1 else 0
               for ns, nw in zip(p.splits, (2, 1)))
    return -(-(n + S * max(p.col_tiles)) // 32) * 32 + part


@functools.cache
def _fn():
    fn = runtime.library("gmm").gmm_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=256)
def _work_ints(S: int, C: int, d: int, f: int, dtype: int) -> int:
    """The C entry's own size of a call's work buffer (``gmm_work_ints``;
    :func:`work_ints` mirrors it)."""
    fn = runtime.library("gmm").gmm_work_ints
    fn.argtypes = [_I, _I, _I, _I, _I]
    fn.restype = ctypes.c_longlong
    n = fn(S, C, d, f, dtype)
    if n < 0:
        raise RuntimeError("gmm: the device cannot run the grouped FFN kernel")
    return n


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
    work = torch.empty(_work_ints(S, C, d, f, _DTYPES[dtype]),
                       dtype=torch.int32, device=dev)
    status = _fn()(buckets.data_ptr(), we_gate.data_ptr(), we_up.data_ptr(),
                   we_down.data_ptr(),
                   None if owner is None else owner.data_ptr(),
                   hidden.data_ptr(), out.data_ptr(), work.data_ptr(),
                   S, C, d, f, E, _DTYPES[dtype],
                   runtime.stream_handle(buckets))
    runtime.check_status(name, status)
    runtime.count_launch(name)
    return out, work[:S]
