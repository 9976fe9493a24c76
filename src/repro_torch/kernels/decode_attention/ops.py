"""GQA decode-attention entry point.

:func:`decode_attention` launches the hand-written CUDA kernel for
tensors on the card and takes the plain version (``ref.py``) only for
tensors on the CPU; any other device raises, and a failed build or
launch on the card raises — there is no fallback. A ragged cache length
and the ring-window mode run in the kernel too.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k, v, positions, *, window: int = 0):
    """q [B, H, hd]; k/v [B, L, KV, hd]; positions [B] (the new token's
    position) → [B, H, hd] f32. ``window > 0``: k/v are a ring buffer,
    slot ``p % window`` holding position ``p``."""
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k, v, positions, window=window)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, positions, window=window)
    raise ValueError(f"decode_attention: no kernel for device {q.device}")
