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
_TILE = 32               # DA_TILE in the source
_MAX_GD = 1024           # DA_MAX_GD in the source
_SPLIT_SLOTS = 512       # most cache slots one block walks


@functools.cache
def _n_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _fn():
    fn = runtime.library("decode_attention").decode_attention_launch
    fn.argtypes = ([_P] * 7 + [_I] * 9 + [_LL] * 6 + [_I, _P])
    fn.restype = _I
    return fn


def split_plan(B: int, KV: int, L: int, n_sms: int):
    """``(split_len, n_split)``: cache slots per block and blocks per
    (batch row, KV head). At least two blocks per SM where the cache has
    enough 32-slot tiles, and no block walks more than ``_SPLIT_SLOTS``
    slots; ``split_len`` is a multiple of the tile."""
    want = max(-(-2 * n_sms // (B * KV)), -(-L // _SPLIT_SLOTS), 1)
    split_len = _TILE * max(1, -(-L // want) // _TILE)
    return split_len, -(-L // split_len)


def decode_attention_cuda(q, k, v, positions, *, window: int = 0):
    """q [B, H, hd]; k/v [B, L, KV, hd] (a view of a stacked cache is
    read in place: the last stride must be 1, the others and the base
    16-byte aligned); positions [B] → [B, H, hd] f32. hd must be 32, 64
    or 128 and ``(H / KV) * hd <= 1024``."""
    B, H, hd = q.shape
    Bk, L, KV, hdk = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k and v must share one dtype "
                        f"in {list(_DTYPES)}")
    if (Bk != B or tuple(v.shape) != tuple(k.shape) or hdk != hd
            or H % KV or hd not in (32, 64, 128)
            or (H // KV) * hd > _MAX_GD or tuple(positions.shape) != (B,)
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
    positions = positions.to(torch.int32).contiguous()
    runtime.require_cuda("decode_attention", q, positions)
    if k.device != q.device or v.device != q.device:
        raise ValueError("decode_attention: every tensor must be on one "
                         "CUDA device")
    dev = q.device
    split_len, n_split = split_plan(B, KV, L, _n_sms(dev))
    # one allocation: out [B, H, hd], then the partials' acc
    # [B, H, n_split, hd] and (m, l) [B, H, n_split, 2]
    n_out, n_acc = B * H * hd, B * H * n_split * hd
    buf = torch.empty((n_out + n_acc + B * H * n_split * 2,),
                      dtype=torch.float32, device=dev)
    out = buf[:n_out].view(B, H, hd)
    part_acc, part_ml = buf[n_out:n_out + n_acc], buf[n_out + n_acc:]
    status = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   positions.data_ptr(), part_acc.data_ptr(),
                   part_ml.data_ptr(), out.data_ptr(), B, H, KV, hd,
                   hd.bit_length() - 1, L, split_len, n_split, int(window),
                   *k.stride()[:3], *v.stride()[:3], _DTYPES[q.dtype],
                   runtime.stream_handle(q))
    runtime.check_status("decode_attention", status)
    runtime.count_launch("decode_attention")
    return out
