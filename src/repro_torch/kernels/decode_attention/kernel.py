"""ctypes wrapper of ``csrc/decode_attention.cu`` (CUDA tensors only)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64               # DA_TILE in the source
_SET_GD = 1024           # heads x hd of a warp set at hd <= 128
_MAX_CLUSTER = 8         # DA_MAX_CLUSTER in the source
_HEAD_DIMS = (32, 64, 128, 256)
_MAX_SPLIT = 64          # parts the ticket merge stages in shared memory
_LONG_SPLIT = 2048       # most slots a block of a one-wave plan walks
_SHORT_TILES = 32        # tiles of a short cache (:func:`split_plan`)
_ONE_BLOCK = 4           # tiles one block walks alone
_MIN_WALK = 96 * 1024    # least K/V bytes a block of a short cache walks
#: blocks of the kernel resident on one SM, by its instantiation (dtype,
#: hd, query heads a warp set takes, warp sets), as
#: ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` counts them on an
#: H100 (``chip_smoke.py`` holds the table to it)
BLOCKS_PER_SM = {
    (torch.bfloat16, 32, 8, 1): 6, (torch.bfloat16, 32, 32, 1): 3,
    (torch.bfloat16, 64, 8, 1): 4, (torch.bfloat16, 64, 16, 1): 3,
    (torch.bfloat16, 128, 8, 1): 2, (torch.bfloat16, 256, 8, 1): 1,
    (torch.bfloat16, 256, 8, 2): 1,
    (torch.float32, 32, 32, 1): 3, (torch.float32, 64, 16, 1): 2,
    (torch.float32, 128, 8, 1): 1, (torch.float32, 256, 8, 1): 1,
    (torch.float32, 256, 8, 2): 1,
}
_LAYOUT = ("decode_attention: k and v need a unit stride on the head "
           "dimension and 16-byte aligned rows")
#: kept launches, by call shape (:func:`_call`)
_CALLS: dict = {}
_MAX_CALLS = 256


class _Args(ctypes.Structure):
    """``DaArgs`` of the source: what a call shape fixes."""
    _fields_ = ([(n, ctypes.c_longlong) for n in
                 ("ksb", "ksl", "ksh", "vsb", "vsl", "vsh")]
                + [("ws", _P), ("tickets", _P)]
                + [(n, _I) for n in ("B", "H", "KV", "hd", "gpb", "sh", "wq",
                                     "L", "split_len", "n_split", "cluster",
                                     "window", "dtype")])


@functools.cache
def _n_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _lib():
    lib = runtime.library("decode_attention")
    lib.decode_attention_run.argtypes = [_P] * 8
    lib.decode_attention_run.restype = _I
    lib.decode_attention_occupancy.argtypes = [_I, _I, _I, _I, _P, _P]
    lib.decode_attention_occupancy.restype = _I
    return lib


def _full_set(hd: int) -> int:
    return max(8, _SET_GD // hd)


def head_groups(G: int, hd: int):
    """``(gpb, n_grp)``: query heads per block and blocks per (batch row,
    KV head, range of slots). A block takes at most one warp set of
    ``max(8, 1024 // hd)`` heads, two sets of 8 at hd 256, so G = 10 at
    hd 256 is one group; more heads are cut into equal groups."""
    most = _full_set(hd) * (2 if hd == 256 else 1)
    n_grp = -(-G // most)
    return -(-G // n_grp), n_grp


def warp_sets(gpb: int, hd: int, dtype: torch.dtype = torch.bfloat16):
    """``(sh, wq)``: query heads a warp set takes and the warp sets (of 4
    warps) of a block of ``gpb`` heads: bf16 query tiles of 8 columns, one
    where 8 heads do, so that no warp multiplies padding it need not."""
    sh = (8 if dtype == torch.bfloat16 and gpb <= 8 or hd == 256
          else _full_set(hd))
    return sh, -(-gpb // sh)


def split_plan(B: int, KV: int, L: int, n_sms: int, *, groups: int = 1,
               per_sm: int = 2, slot_bytes: int = 512):
    """``(split_len, n_split)``: cache slots per block and blocks per
    (batch row, KV head, head group), a function of the shapes alone.

    A short cache (at most ``_SHORT_TILES`` 64-slot tiles) is one block
    where it has at most ``_ONE_BLOCK`` tiles, else ranges of at least
    ``_MIN_WALK`` bytes of K and V (``slot_bytes`` a slot: 3 tiles at hd
    128 in bf16, 6 at hd 64), at most ``_MAX_CLUSTER`` of them, merged
    inside one cluster: a block's fixed costs and the merge outweigh a
    shorter walk. A longer cache fills one wave of the card (``per_sm``
    blocks per SM) as far as it has tiles; where a block would then walk
    more than ``_LONG_SPLIT`` slots, two waves of half as long, so that a
    batch whose rows are short but for one does not wait on few long
    blocks.
    Where the splits make a cluster (2-8) and the card holds the call in
    one wave, the clusters take at most 7/8 of the wave: a cluster's
    blocks share a GPC, and the last GPC slots stay empty (30 clusters
    of 8 where 33 would fill an H100 at two blocks an SM).
    ``split_len`` is a multiple of the tile and ``n_split`` at most
    ``_MAX_SPLIT``."""
    tiles = -(-L // _TILE)
    pairs = B * KV * groups
    wave = per_sm * n_sms
    if tiles <= _SHORT_TILES:
        least = -(-_MIN_WALK // (_TILE * slot_bytes))   # tiles a block
        want = (1 if tiles <= _ONE_BLOCK
                else min(_MAX_CLUSTER, -(-tiles // least)))
    else:
        want = max(1, min(wave // pairs, tiles, _MAX_SPLIT))
        if _TILE * -(-tiles // want) > _LONG_SPLIT:
            want = min(2 * want, tiles, _MAX_SPLIT)
    fit = 7 * wave // (8 * pairs)
    if 1 < want <= _MAX_CLUSTER and pairs * want <= wave and fit >= 2:
        want = min(want, fit)
    split_len = _TILE * -(-tiles // want)
    return split_len, -(-L // split_len)


def plan(B: int, H: int, KV: int, hd: int, L: int, n_sms: int,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launch of one call: head groups (:func:`head_groups`), warp
    sets, the blocks an SM holds (:data:`BLOCKS_PER_SM`), the split of
    the cache (:func:`split_plan`) and the merge: ``cluster`` blocks
    (``n_split`` when 2-8) merge through distributed shared memory, 1
    with ``n_split > 1`` is the ticket merge."""
    gpb, n_grp = head_groups(H // KV, hd)
    sh, wq = warp_sets(gpb, hd, dtype)
    per_sm = BLOCKS_PER_SM[dtype, hd, sh, wq]
    split_len, n_split = split_plan(
        B, KV, L, n_sms, groups=n_grp, per_sm=per_sm,
        slot_bytes=2 * hd * torch.empty((), dtype=dtype).element_size())
    return dict(gpb=gpb, n_grp=n_grp, sh=sh, wq=wq, per_sm=per_sm,
                split_len=split_len, n_split=n_split,
                cluster=n_split if 1 < n_split <= _MAX_CLUSTER else 1,
                grid=(n_split, KV * n_grp, B), threads=128 * wq)


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


def merge_work(p: dict, G: int, hd: int, split: int):
    """Output elements of its group (of ``G * hd``) that block ``split``
    of a cluster merges: ``range(j GD / n, (j + 1) GD / n)``; the whole
    group for the last block of the ticket merge and for one split."""
    GD, n = G * hd, p["n_split"]
    if p["cluster"] == 1:
        return range(GD)
    return range(split * GD // n, (split + 1) * GD // n)


def occupancy(dtype: torch.dtype, hd: int, sh: int, wq: int,
              device: torch.device) -> tuple:
    """(blocks on one SM, clusters of 8 on the card) of the instantiation
    ``(dtype, hd, sh, wq)`` on ``device``, as the CUDA runtime counts
    them."""
    blocks, clusters = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        runtime.check_status("decode_attention_occupancy",
                             _lib().decode_attention_occupancy(
                                 _DTYPES[dtype], hd, sh, wq,
                                 ctypes.addressof(blocks),
                                 ctypes.addressof(clusters)))
    return blocks.value, clusters.value


def _check(q, k, v, positions, window):
    """Raise on what the kernel does not take (shapes, dtypes, layout,
    devices), layout before device; checked once per call shape."""
    B, H, hd = q.shape
    Bk, L, KV, hdk = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k and v must share one dtype "
                        f"in {list(_DTYPES)}")
    if (Bk != B or tuple(v.shape) != tuple(k.shape) or hdk != hd
            or H % KV or hd not in _HEAD_DIMS
            or tuple(positions.shape) != (B,) or window < 0):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"positions {tuple(positions.shape)}, "
                         f"window {window}")
    vec = 16 // q.element_size()          # values per 16-byte load
    if (k.stride(-1) != 1 or v.stride(-1) != 1
            or any(st % vec for st in k.stride()[:3] + v.stride()[:3])
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError(_LAYOUT)
    runtime.require_cuda("decode_attention", q.contiguous(),
                         positions.to(torch.int32).contiguous())
    if k.device != q.device or v.device != q.device:
        raise ValueError("decode_attention: every tensor must be on one "
                         "CUDA device")


def _call(q, k, v, window: int, p: dict):
    """The kept launch of one call shape: its argument block (with the
    ticket merge's workspace, all tickets 0) and output shapes."""
    B, H, hd = q.shape
    _, L, KV, _ = k.shape
    a = _Args(*k.stride()[:3], *v.stride()[:3], None, None, B, H, KV, hd,
              p["gpb"], p["sh"], p["wq"], L, p["split_len"], p["n_split"],
              p["cluster"], int(window), _DTYPES[q.dtype])
    ws = tickets = None
    if p["n_split"] > 1 and p["cluster"] == 1:
        pairs = B * KV * p["n_grp"]
        ws = torch.empty((pairs * p["n_split"] * (p["gpb"] * hd
                                                  + 2 * p["gpb"]),),
                         dtype=torch.float32, device=q.device)
        tickets = torch.zeros((pairs,), dtype=torch.int32, device=q.device)
        a.ws, a.tickets = ws.data_ptr(), tickets.data_ptr()
    return dict(args=a, addr=ctypes.addressof(a), ws=ws, tickets=tickets,
                plan=p, out=(B, H, hd), ml=(B, H, 2))


def decode_attention_cuda(q, k, v, positions, *, window: int = 0,
                          partial: bool = False):
    """q [B, H, hd]; k/v [B, L, KV, hd] (a view of a stacked cache is
    read in place: the last stride must be 1, the others and the base
    16-byte aligned); positions [B] → [B, H, hd] f32. hd must be 32, 64,
    128 or 256; a KV head's query heads are taken in groups
    (:func:`head_groups`). One kernel launch: the splits of the cache and
    the groups are combined inside it. The plan and the argument block
    of a call shape (shapes, strides, dtype, window, partial, device,
    stream) are kept after its first call.

    ``partial=True`` (a shard of a sequence-sharded cache) returns
    ``(acc, m, l)``: the unnormalised ``acc`` [B, H, hd] f32, each
    row's max score ``m`` and exp-sum ``l`` [B, H] f32, counted as
    ``decode_attention_partial``."""
    runtime.refuse_grad("decode_attention", q, k, v)
    dev = q.device
    if dev.type != "cuda":
        _check(q, k, v, positions, window)      # raises
    stream = runtime.stream_handle(q)
    key = (q.shape, q.dtype, k.shape, k.stride(), k.dtype, k.device,
           v.shape, v.stride(), v.dtype, v.device, window, partial, dev,
           stream)
    c = _CALLS.get(key)
    if c is None:
        _check(q, k, v, positions, window)
        B, H, hd = q.shape
        _, L, KV, _ = k.shape
        c = _call(q, k, v, window,
                  plan(B, H, KV, hd, L, _n_sms(dev), q.dtype))
        if len(_CALLS) >= _MAX_CALLS:
            _CALLS.clear()
        _CALLS[key] = c
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(_LAYOUT)
    if tuple(positions.shape) != c["out"][:1]:
        raise ValueError(f"decode_attention: positions "
                         f"{tuple(positions.shape)} for {c['out'][0]} rows")
    if positions.dtype != torch.int32 or not positions.is_contiguous():
        positions = positions.to(torch.int32).contiguous()
    if positions.device != dev:
        raise ValueError("decode_attention: every tensor must be on one "
                         "CUDA device")
    q = q.contiguous()
    out = torch.empty(c["out"], dtype=torch.float32, device=dev)
    ml = (torch.empty(c["ml"], dtype=torch.float32, device=dev)
          if partial else None)
    status = _lib().decode_attention_run(
        c["addr"], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        positions.data_ptr(), out.data_ptr(),
        None if ml is None else ml.data_ptr(), stream)
    runtime.check_status("decode_attention", status)
    if partial:
        runtime.count_launch("decode_attention_partial")
        return out, ml[..., 0], ml[..., 1]
    runtime.count_launch("decode_attention")
    return out
