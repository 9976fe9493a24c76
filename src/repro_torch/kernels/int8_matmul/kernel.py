"""ctypes wrapper of ``csrc/int8_matmul.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
#: largest depth whose int32 sums are exact: 127² · K < 2³¹
MAX_K = 133143
_BK = 128                 # IM_BK in the source: K per stage of TMA variants
_DECODE_BN = 64           # DC_BN: weight rows per decode block
#: the decode (swap-AB, split-K) variant takes M up to this; wider M goes
#: to the 128-row tiles
DECODE_MAX_M = 64
_BLOCKS_PER_SM = 2        # the decode plan keeps at least this many
_PATHS = {"ragged": 0, "decode": 1, "wide": 2}
#: (device, stream) → (int32 partials, int32 tickets): kept across calls,
#: since every call leaves its tickets at 0
_WORKSPACE: dict = {}


class Plan(NamedTuple):
    """How one call runs: the variant (``ragged``, ``decode`` or
    ``wide``); ``nb``, the decode variant's token rows padded to the wgmma
    width (8 or 64) or the wide variant's tile width (128, 192 or 256),
    else 0; and the split of K: ``n_split`` ranges of ``chunk``
    128-deep k-tiles each (the last one shorter)."""
    path: str
    nb: int
    chunk: int
    n_split: int


@functools.cache
def _n_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _fn():
    fn = runtime.library("int8_matmul").int8_matmul_launch
    fn.argtypes = [_P] * 7 + [_I] * 7 + [_P]
    fn.restype = _I
    return fn


@functools.cache
def plan(M: int, K: int, N: int, n_sms: int, aligned: bool = True) -> Plan:
    """The launch of an ``[M, K] x [K, N]`` call on a card of ``n_sms``
    SMs, a function of the shapes alone (and of whether the bases are
    16-byte aligned). TMA needs K-contiguous rows of a multiple of 16
    bytes: other K, or an unaligned base, take the ragged variant.

    M above ``DECODE_MAX_M`` takes the wide variant, with the tile width
    whose waves of one tile per SM take least time: ``ceil(tiles /
    n_sms) * width``, ties to the wider tile (N 18432 at M 512: 192,
    three full waves, where 256 leaves the third 18% full).

    Smaller M takes the decode variant. One block streams 64 weight rows,
    so N gives ``ceil(N / 64)`` blocks; K is split only when those are
    fewer than two per SM, into as many ranges as make them two per SM
    (whole 128-deep tiles, the last range shorter). More splits cost more
    than they save once every SM streams: each adds partials to write and
    read back, and a start-up per block."""
    k_tiles = -(-K // _BK)
    if K % 16 or not aligned:
        return Plan("ragged", 0, k_tiles, 1)
    if M > DECODE_MAX_M:
        m_tiles = -(-M // 128)
        bn = min((256, 192, 128),
                 key=lambda w: (-(-m_tiles * -(-N // w) // n_sms) * w, -w))
        return Plan("wide", bn, k_tiles, 1)
    nb = 8 if M <= 8 else 64
    n_tiles = -(-N // _DECODE_BN)
    want = -(-_BLOCKS_PER_SM * n_sms // n_tiles)
    if want <= 1:
        return Plan("decode", nb, k_tiles, 1)
    chunk = max(1, k_tiles // want)
    return Plan("decode", nb, chunk, -(-k_tiles // chunk))


def k_ranges(p: Plan, K: int) -> list:
    """The ``[k0, k1)`` range of K each split of plan ``p`` sums."""
    return [(s * p.chunk * _BK, min(K, (s + 1) * p.chunk * _BK))
            for s in range(p.n_split)]


def _workspace(dev: torch.device, stream: int, n_part: int, n_tile: int):
    """Partials (int32, at least ``n_part``) and tickets (int32, at least
    ``n_tile``, all 0) of one stream; grown, never shrunk."""
    key = (dev, stream)
    part, tickets = _WORKSPACE.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty((n_part,), dtype=torch.int32, device=dev)
    if tickets is None or tickets.numel() < n_tile:
        tickets = torch.zeros((n_tile,), dtype=torch.int32, device=dev)
    _WORKSPACE[key] = (part, tickets)
    return part, tickets


def int8_matmul_cuda(x_q, x_scale, w_q, w_scale):
    """x_q [M, K] int8, x_scale [M] f32, w_q [K, N] int8 stored K-major
    (strides (1, K): the transposed view of an [N, K] row-major tensor,
    as ``QTensor`` keeps it), w_scale [N] f32 → [M, N] f32, bit-identical
    to :func:`int8_matmul_ref`. Any M, K ≤ 133143 and N. One launch."""
    runtime.refuse_grad("int8_matmul", x_q, x_scale, w_q, w_scale)
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
    if not w_q.t().is_contiguous():
        raise ValueError(f"int8_matmul: w_q must be K-major (strides (1, "
                         f"{K}), the transposed view of an [N, K] row-major "
                         f"tensor), got strides {tuple(w_q.stride())}; a "
                         f"row-major [K, N] weight would need a copy per call")
    x_q = x_q.contiguous()
    x_scale, w_scale = x_scale.contiguous(), w_scale.contiguous()
    runtime.require_cuda("int8_matmul", x_q, x_scale, w_q.t(), w_scale)
    dev = x_q.device
    p = plan(M, K, N, _n_sms(dev),
             aligned=x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    stream = runtime.stream_handle(x_q)
    part = tickets = None
    if p.n_split > 1:
        n_tiles = -(-N // _DECODE_BN)
        part, tickets = _workspace(dev, stream,
                                   p.n_split * n_tiles * 64 * p.nb, n_tiles)
    status = _fn()(x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(),
                   w_scale.data_ptr(), out.data_ptr(),
                   None if part is None else part.data_ptr(),
                   None if tickets is None else tickets.data_ptr(),
                   M, N, K, _PATHS[p.path], p.nb, p.chunk, p.n_split, stream)
    runtime.check_status("int8_matmul", status)
    runtime.count_launch("int8_matmul")
    return out
