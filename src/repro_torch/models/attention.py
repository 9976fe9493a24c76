"""Attention mixers: GQA attention (global, or a sliding window over a
ring buffer), cross-attention over a fixed memory (VLM image layers and
the encoder-decoder's decoder), and DeepSeek multi-head latent attention
(MLA).

Four execution modes, as in the reference:

  * ``prefill`` — full sequence; returns the layer's cache (GQA: roped
    ``k``/``v`` [B, S, KV, hd], or with a window shorter than S its
    trailing ``window`` positions, position ``p`` at ring slot ``p %
    window``; MLA: latent ``ckv`` [B, S, kv_lora_rank], ``krope`` [B, S,
    rope_dim]). Above ``NAIVE_MAX_LEN`` tokens the scores go through
    ``blockwise_attention``, as in the reference.
  * ``train``   — the prefill's computation without a cache: nothing is
    built or written in place, so autograd can run through it.
  * ``chunk``   — chunked prefill: the chunk's K/V (or latents) are
    written IN PLACE into the layer's full-length cache buffer at
    ``offset``, and the chunk attends causally over the whole buffer
    with explicit position masks (same values as a monolithic prefill on
    the valid region). Global attention only, as in the reference.
  * ``decode``  — one new token per row: its K/V (or latents) are
    written IN PLACE at ``positions`` (ring slot ``positions % window``
    with a window; the reference donates the buffer instead), then the
    token attends over the slots it sees. GQA decode runs the
    decode-attention kernel (``kernels/decode_attention``, ring mode
    with a window); MLA decode is the absorbed form: the query is folded
    into latent space (``q_nope · wk_b``) and scored against the latent
    cache directly.

Cross-attention is neither causal nor roped: prefill projects the
memory to K/V once and returns them as the layer's cache; decode reads
that cache and never writes it, attending over every slot through the
decode-attention kernel.

The per-layer cache is a dict of tensors; in-place writes through views
of the stacked superblock cache update the stack itself. The
reference's tensor-parallel head padding has no counterpart on one
card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models.common import (apply_rope, blockwise_attention,
                                       naive_attention, rms_norm)

Cache = Dict[str, torch.Tensor]
#: longest prompt the naive prefill attention takes (above it, blockwise
#: attention, as in the reference)
NAIVE_MAX_LEN = 2048


def _prefill_attention(q, k, v, window: int = 0):
    """Causal prefill attention, naive up to ``NAIVE_MAX_LEN`` tokens and
    blockwise above, as the reference picks."""
    if q.shape[1] > NAIVE_MAX_LEN:
        return blockwise_attention(q, k, v, causal=True, window=window)
    return naive_attention(q, k, v, causal=True, window=window)


def _write_new_token(leaf, new, positions):
    """``leaf`` [B, L, ...] ← ``new`` [B, ...] at slot ``positions[b]``,
    in place; a row whose position lies outside the buffer keeps the
    buffer unchanged."""
    B, L = leaf.shape[:2]
    owned = ((positions >= 0) & (positions < L)).view(
        B, *([1] * (new.dim() - 1)))
    safe = positions.clamp(0, L - 1).long()
    bidx = torch.arange(B, device=leaf.device)
    leaf[bidx, safe] = torch.where(owned, new.to(leaf.dtype),
                                   leaf[bidx, safe])


# ===========================================================================
# GQA attention (global or sliding window)
# ===========================================================================
def attn_param_shapes(cfg: ModelConfig):
    """name → (shape, fan_in)."""
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {"wq": ((d, H, hd), d), "wk": ((d, KV, hd), d),
            "wv": ((d, KV, hd), d), "wo": ((H, hd, d), H * hd)}


def attn_cache_spec(cfg: ModelConfig, batch: int, max_len: int,
                    window: int = 0):
    """Shapes of the layer's K/V cache: ``max_len`` slots, or with a
    window a ring of ``min(max_len, window)``."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    L = min(max_len, window) if window > 0 else max_len
    return {"k": (batch, L, KV, hd), "v": (batch, L, KV, hd)}


def _project_qkv(params, x, cfg: ModelConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attn_apply(params, x, *, cfg: ModelConfig, mode: str,
               window: int = 0, cache: Optional[Cache] = None,
               positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Causal GQA, global (``window == 0``) or over the last ``window``
    positions. ``positions``: the chunk offset (an int) in ``chunk``
    mode, the new tokens' positions [B] in ``decode`` mode."""
    S = x.shape[1]
    if mode in ("prefill", "train"):
        q, k, v = _project_qkv(params, x, cfg,
                               torch.arange(S, device=x.device))
        o = _prefill_attention(q, k, v, window)
        y = torch.einsum("bshk,hkd->bsd", o, params["wo"])
        if mode == "train":
            return y, None
        if window > 0 and S > window:
            # the trailing window, position p at ring slot p % window
            slots = (torch.arange(window, device=x.device)
                     + (S - window)) % window
            ring = {}
            for n, t in (("k", k), ("v", v)):
                ring[n] = torch.empty_like(t[:, :window])
                ring[n][:, slots] = t[:, S - window:]
            return y, ring
        return y, {"k": k, "v": v}
    if mode == "chunk":
        if window:
            raise ValueError("chunked prefill needs global attention "
                             f"(window {window})")
        return _attn_chunk(params, x, cfg=cfg, cache=cache, offset=positions)
    if mode != "decode":
        raise ValueError(f"attn_apply: unsupported mode {mode!r}")
    q, k_new, v_new = _project_qkv(params, x, cfg, positions[:, None])
    slot = torch.remainder(positions, window) if window > 0 else positions
    _write_new_token(cache["k"], k_new[:, 0], slot)
    _write_new_token(cache["v"], v_new[:, 0], slot)
    o = decode_attention(q[:, 0], cache["k"], cache["v"], positions,
                         window=window).to(q.dtype)
    return torch.einsum("bshk,hkd->bsd", o[:, None], params["wo"]), cache


def _attn_chunk(params, x, *, cfg: ModelConfig, cache: Cache, offset: int):
    """Write the chunk's roped K/V into the buffer at ``offset`` (in
    place), then attend causally over the whole buffer with explicit
    position masks."""
    B, S, _ = x.shape
    L = cache["k"].shape[1]
    if offset + S > L:
        raise ValueError(f"chunk [{offset}, {offset + S}) exceeds buffer {L}")
    pos = offset + torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, pos)
    cache["k"][:, offset:offset + S] = k.to(cache["k"].dtype)
    cache["v"][:, offset:offset + S] = v.to(cache["v"].dtype)
    o = naive_attention(q, cache["k"], cache["v"], q_positions=pos,
                        kv_positions=torch.arange(L, device=x.device))
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), cache


# ===========================================================================
# Cross attention (VLM image layers, the encoder-decoder's decoder)
# ===========================================================================
def cross_attn_param_shapes(cfg: ModelConfig):
    """name → (shape, fan_in); K/V project the memory, of width
    ``encoder_d_model`` (0: ``d_model``)."""
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    md = cfg.encoder_d_model or d
    return {"wq": ((d, H, hd), d), "wk": ((md, KV, hd), md),
            "wv": ((md, KV, hd), md), "wo": ((H, hd, d), H * hd)}


def cross_attn_cache_spec(cfg: ModelConfig, batch: int, mem_len: int):
    """The memory's K/V: ``mem_len`` slots."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": (batch, mem_len, KV, hd), "v": (batch, mem_len, KV, hd)}


def cross_attn_apply(params, x, *, cfg: ModelConfig, mode: str,
                     memory: Optional[torch.Tensor] = None,
                     cache: Optional[Cache] = None
                     ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Attention of ``x`` over a memory, with no RoPE and no mask.
    ``prefill``: ``memory`` [B, M, md] → K/V, returned as the cache
    (``train``: no cache).
    ``decode``: the cache's K/V, read only; every slot is attended (the
    kernel at ``positions = L - 1``), the zero-padded ones of a memory
    shorter than the slot too, as the reference's ``naive_attention``
    attends them."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if mode in ("prefill", "train"):
        if memory is None:
            raise ValueError(f"cross-attention {mode} needs the memory")
        k = torch.einsum("bmd,dhk->bmhk", memory, params["wk"])
        v = torch.einsum("bmd,dhk->bmhk", memory, params["wv"])
        o = naive_attention(q, k, v, causal=False)
        y = torch.einsum("bshk,hkd->bsd", o, params["wo"])
        return y, ({"k": k, "v": v} if mode == "prefill" else None)
    if mode != "decode":
        raise ValueError(f"cross_attn_apply: unsupported mode {mode!r}")
    B, L = cache["k"].shape[:2]
    last = torch.full((B,), L - 1, dtype=torch.int32, device=x.device)
    o = decode_attention(q[:, 0], cache["k"], cache["v"], last).to(q.dtype)
    return torch.einsum("bshk,hkd->bsd", o[:, None], params["wo"]), cache


# ===========================================================================
# MLA
# ===========================================================================


def mla_param_shapes(cfg: ModelConfig):
    """name → (shape, fan_in or None for a norm scale)."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    return {
        "wq_a": ((d, m.q_lora_rank), d),
        "q_norm": ((m.q_lora_rank,), None),
        "wq_b": ((m.q_lora_rank, H, m.qk_nope_head_dim + m.qk_rope_head_dim),
                 m.q_lora_rank),
        "wkv_a": ((d, m.kv_lora_rank + m.qk_rope_head_dim), d),
        "kv_norm": ((m.kv_lora_rank,), None),
        "wk_b": ((m.kv_lora_rank, H, m.qk_nope_head_dim), m.kv_lora_rank),
        "wv_b": ((m.kv_lora_rank, H, m.v_head_dim), m.kv_lora_rank),
        "wo": ((H, m.v_head_dim, d), H * m.v_head_dim),
    }


def mla_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    m = cfg.mla
    return {"ckv": (batch, max_len, m.kv_lora_rank),
            "krope": (batch, max_len, m.qk_rope_head_dim)}


def _mla_qkv_latent(params, x, cfg: ModelConfig, positions):
    """q (nope, rope) and the latent kv (ckv, krope) of ``x`` [B, S, d]."""
    m = cfg.mla
    cq = rms_norm(torch.matmul(x, params["wq_a"]), params["q_norm"],
                  cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["wq_b"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    kv = torch.matmul(x, params["wkv_a"])
    ckv = rms_norm(kv[..., :m.kv_lora_rank], params["kv_norm"], cfg.norm_eps)
    krope = apply_rope(kv[..., None, m.kv_lora_rank:], positions,
                       cfg.rope_theta)[:, :, 0]                 # [B,S,rope]
    return q_nope, q_rope, ckv, krope


def _expand_attend(params, q_nope, q_rope, ckv, krope, cfg: ModelConfig,
                   q_positions=None, kv_positions=None):
    """Expanded (per-head K/V) causal attention + output projection;
    a prefill (no positions) above ``NAIVE_MAX_LEN`` tokens is
    blockwise."""
    B, L, _ = ckv.shape
    H = cfg.num_heads
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, params["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", ckv, params["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None].expand(
        B, L, H, cfg.mla.qk_rope_head_dim)], dim=-1)
    if q_positions is None:
        o = _prefill_attention(q, k, v)
    else:
        o = naive_attention(q, k, v, q_positions=q_positions,
                            kv_positions=kv_positions)
    return torch.einsum("bshk,hkd->bsd", o, params["wo"])


def mla_apply(params, x, *, cfg: ModelConfig, mode: str,
              cache: Optional[Cache] = None,
              positions: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """``positions``: the chunk offset (an int) in ``chunk`` mode, the
    new tokens' positions [B] in ``decode`` mode."""
    m = cfg.mla
    B, S, _ = x.shape
    if mode in ("prefill", "train"):
        pos = torch.arange(S, device=x.device)
        q_nope, q_rope, ckv, krope = _mla_qkv_latent(params, x, cfg, pos)
        y = _expand_attend(params, q_nope, q_rope, ckv, krope, cfg)
        return y, ({"ckv": ckv, "krope": krope} if mode == "prefill"
                   else None)
    if mode == "chunk":
        return _mla_chunk(params, x, cfg=cfg, cache=cache, offset=positions)
    if mode != "decode":
        raise ValueError(f"mla_apply: unsupported mode {mode!r}")
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_latent(
        params, x, cfg, positions[:, None])
    # absorbed: q' = q_nope · wk_b^T → latent-space scores against ckv
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["wk_b"])
    o_lat = _mla_decode(q_lat, q_rope, ckv_new, krope_new, cache, positions,
                        scale_dim=m.qk_nope_head_dim + m.qk_rope_head_dim)
    o = torch.einsum("bshr,rhk->bshk", o_lat, params["wv_b"])
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), cache


def _mla_chunk(params, x, *, cfg: ModelConfig, cache: Cache, offset: int):
    """Write the chunk's latents into the buffer at ``offset`` (in place),
    then attend over the whole buffer with explicit position masks."""
    B, S, _ = x.shape
    L = cache["ckv"].shape[1]
    if offset + S > L:
        raise ValueError(f"chunk [{offset}, {offset + S}) exceeds buffer {L}")
    pos = offset + torch.arange(S, device=x.device)
    q_nope, q_rope, ckv, krope = _mla_qkv_latent(params, x, cfg, pos)
    cache["ckv"][:, offset:offset + S] = ckv.to(cache["ckv"].dtype)
    cache["krope"][:, offset:offset + S] = krope.to(cache["krope"].dtype)
    y = _expand_attend(params, q_nope, q_rope, cache["ckv"], cache["krope"],
                       cfg, q_positions=pos,
                       kv_positions=torch.arange(L, device=x.device))
    return y, cache


def _mla_decode(q_lat, q_rope, ckv_new, krope_new, cache: Cache, positions,
                scale_dim: int):
    """Write each row's new latents at ``positions`` (in place; a row
    whose position lies outside the buffer keeps the buffer unchanged),
    then attend over slots ``<= position``. Returns [B, 1, H, r]."""
    ckv_c, krope_c = cache["ckv"], cache["krope"]
    L = ckv_c.shape[1]
    scale = 1.0 / np.sqrt(scale_dim)
    _write_new_token(ckv_c, ckv_new[:, 0], positions)
    _write_new_token(krope_c, krope_new[:, 0], positions)
    valid = torch.arange(L, device=positions.device)[None, :] \
        <= positions[:, None]
    s = (torch.einsum("bhr,blr->bhl", q_lat[:, 0].float(), ckv_c.float())
         + torch.einsum("bhk,blk->bhl", q_rope[:, 0].float(),
                        krope_c.float())) * scale
    s = s.masked_fill(~valid[:, None, :], float("-inf"))
    mx = s.amax(dim=-1)
    safe_m = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    p = torch.where(torch.isfinite(s), torch.exp(s - safe_m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhl,blr->bhr", p.to(ckv_c.dtype).float(),
                       ckv_c.float())
    out = (acc / torch.clamp(l[..., None], min=1e-30))[:, None]
    return out.to(q_lat.dtype)
