"""ctypes wrapper of ``csrc/decode_attention.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64               # DA_TILE in the source
_MAX_GD = 1024           # DA_MAX_GD in the source
_BLOCKS_PER_SM = 2       # bf16 blocks resident on one SM up to hd 128
_HEAD_DIMS = (32, 64, 128, 256)
_MAX_SPLIT = 64          # parts the combine stages in shared memory
_LONG_SPLIT = 2048       # most slots a block of a one-wave plan walks
#: (device, stream) → (partials workspace, tickets): kept across calls,
#: since every call leaves its tickets at 0
_WORKSPACE: dict = {}


@functools.cache
def _n_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _fn():
    fn = runtime.library("decode_attention").decode_attention_launch
    fn.argtypes = ([_P] * 8 + [_I] * 9 + [_LL] * 6 + [_I, _P])
    fn.restype = _I
    return fn


def head_groups(G: int, hd: int):
    """``(gpb, n_grp)``: query heads per block and blocks per (batch row,
    KV head, range of slots). A block takes at most ``_MAX_GD // hd`` of
    the ``G`` heads that share a KV head (hd 256, G 10: groups of 4, 4
    and 2); one group whenever ``G * hd <= _MAX_GD``."""
    gpb = min(G, _MAX_GD // hd)
    return gpb, -(-G // gpb)


def blocks_per_sm(hd: int) -> int:
    """Blocks of the kernel one SM holds, as the plan counts them: a bf16
    block at hd 256 takes 194 KB of shared memory, so one."""
    return 1 if hd > 128 else _BLOCKS_PER_SM


def split_plan(B: int, KV: int, L: int, n_sms: int, *, groups: int = 1,
               per_sm: int = _BLOCKS_PER_SM):
    """``(split_len, n_split)``: cache slots per block and blocks per
    (batch row, KV head, head group), a function of the shapes alone.
    The blocks of a call fill one wave of the card (``per_sm`` per SM)
    as far as the cache has 64-slot tiles; where a block would then walk
    more than ``_LONG_SPLIT`` slots, two waves of half as long, so that
    a batch whose rows are short but for one does not wait on few long
    blocks. ``split_len`` is a multiple of the tile and ``n_split`` at
    most ``_MAX_SPLIT``."""
    tiles = -(-L // _TILE)
    want = max(1, min(per_sm * n_sms // (B * KV * groups), tiles,
                      _MAX_SPLIT))
    if _TILE * -(-tiles // want) > _LONG_SPLIT:
        want = min(2 * want, tiles, _MAX_SPLIT)
    split_len = _TILE * -(-tiles // want)
    return split_len, -(-L // split_len)


def plan(B: int, H: int, KV: int, hd: int, L: int, n_sms: int) -> dict:
    """The launch of one call: head groups (:func:`head_groups`) and the
    split of the cache (:func:`split_plan`) for these shapes."""
    gpb, n_grp = head_groups(H // KV, hd)
    split_len, n_split = split_plan(B, KV, L, n_sms, groups=n_grp,
                                    per_sm=blocks_per_sm(hd))
    return dict(gpb=gpb, n_grp=n_grp, split_len=split_len, n_split=n_split,
                grid=(n_split, KV * n_grp, B))


def block_work(p: dict, H: int, KV: int, L: int, positions, window: int,
               split: int, y: int, b: int):
    """What block ``(split, y, b)`` of the launch ``p`` computes, by the
    kernel's own index arithmetic: (query heads, slots it walks). With
    ``window == 0`` the walk stops after the row's position."""
    G = H // KV
    kvh, g0 = y // p["n_grp"], (y % p["n_grp"]) * p["gpb"]
    heads = range(kvh * G + g0, kvh * G + g0 + min(p["gpb"], G - g0))
    lo = split * p["split_len"]
    hi = min(L, lo + p["split_len"])
    if window == 0:
        hi = min(hi, int(positions[b]) + 1)
    return heads, range(lo, max(lo, hi))


def _workspace(dev: torch.device, stream: int, n_part: int, n_pair: int):
    """Partials (float32, at least ``n_part``) and tickets (int32, at least
    ``n_pair``, all 0) of one stream; grown, never shrunk."""
    key = (dev, stream)
    ws, tickets = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < n_part:
        ws = torch.empty((n_part,), dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < n_pair:
        tickets = torch.zeros((n_pair,), dtype=torch.int32, device=dev)
    _WORKSPACE[key] = (ws, tickets)
    return ws, tickets


def decode_attention_cuda(q, k, v, positions, *, window: int = 0,
                          partial: bool = False):
    """q [B, H, hd]; k/v [B, L, KV, hd] (a view of a stacked cache is
    read in place: the last stride must be 1, the others and the base
    16-byte aligned); positions [B] → [B, H, hd] f32. hd must be 32, 64,
    128 or 256; a KV head's query heads are taken in groups of at most
    ``1024 // hd`` (:func:`head_groups`). One kernel launch: the splits
    of the cache and the groups are combined inside it.

    ``partial=True`` (a shard of a sequence-sharded cache) returns
    ``(acc, m, l)``: the unnormalised ``acc`` [B, H, hd] f32, each
    row's max score ``m`` and exp-sum ``l`` [B, H] f32, counted as
    ``decode_attention_partial``."""
    runtime.refuse_grad("decode_attention", q, k, v)
    B, H, hd = q.shape
    Bk, L, KV, hdk = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k and v must share one dtype "
                        f"in {list(_DTYPES)}")
    if (Bk != B or tuple(v.shape) != tuple(k.shape) or hdk != hd
            or H % KV or hd not in _HEAD_DIMS
            or tuple(positions.shape) != (B,)
            or window < 0):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"positions {tuple(positions.shape)}, "
                         f"window {window}")
    vec = 16 // q.element_size()          # values per 16-byte load
    if (k.stride(-1) != 1 or v.stride(-1) != 1
            or any(st % vec for st in k.stride()[:3] + v.stride()[:3])
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("decode_attention: k and v need a unit stride on "
                         "the head dimension and 16-byte aligned rows")
    q = q.contiguous()
    if positions.dtype != torch.int32 or not positions.is_contiguous():
        positions = positions.to(torch.int32).contiguous()
    runtime.require_cuda("decode_attention", q, positions)
    if k.device != q.device or v.device != q.device:
        raise ValueError("decode_attention: every tensor must be on one "
                         "CUDA device")
    dev = q.device
    p = plan(B, H, KV, hd, L, _n_sms(dev))
    gpb, n_split, pairs = p["gpb"], p["n_split"], B * KV * p["n_grp"]
    stream = runtime.stream_handle(q)
    ws, tickets = _workspace(dev, stream,
                             pairs * n_split * (gpb * hd + 2 * gpb), pairs)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    ml = (torch.empty((B, H, 2), dtype=torch.float32, device=dev)
          if partial else None)
    status = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   positions.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
                   out.data_ptr(), None if ml is None else ml.data_ptr(),
                   B, H, KV, hd, gpb, L, p["split_len"],
                   n_split, int(window), *k.stride()[:3], *v.stride()[:3],
                   _DTYPES[q.dtype], stream)
    runtime.check_status("decode_attention", status)
    if partial:
        runtime.count_launch("decode_attention_partial")
        return out, ml[..., 0], ml[..., 1]
    runtime.count_launch("decode_attention")
    return out
