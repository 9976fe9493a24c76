"""Attention mixers: GQA global attention and DeepSeek multi-head latent
attention (MLA).

Three execution modes, as in the reference:

  * ``prefill`` — full sequence; returns the layer's cache (GQA: roped
    ``k``/``v`` [B, S, KV, hd]; MLA: latent ``ckv`` [B, S,
    kv_lora_rank], ``krope`` [B, S, rope_dim]).
  * ``chunk``   — chunked prefill: the chunk's K/V (or latents) are
    written IN PLACE into the layer's full-length cache buffer at
    ``offset``, and the chunk attends causally over the whole buffer
    with explicit position masks (same values as a monolithic prefill on
    the valid region).
  * ``decode``  — one new token per row: its K/V (or latents) are
    written IN PLACE at ``positions`` (the reference donates the buffer
    instead), then the token attends over slots ``<= position``. GQA
    decode runs the decode-attention kernel
    (``kernels/decode_attention``); MLA decode is the absorbed form: the
    query is folded into latent space (``q_nope · wk_b``) and scored
    against the latent cache directly.

The per-layer cache is a dict of tensors; in-place writes through views
of the stacked superblock cache update the stack itself. The GQA mixer
here is global attention only (the reference's ring-window layout,
``blockwise_attention`` for prompts over 2048 tokens and tensor-parallel
head padding wait for later slices).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models.common import apply_rope, naive_attention, rms_norm

Cache = Dict[str, torch.Tensor]
#: longest prompt the naive prefill attention takes (the reference
#: switches to blockwise attention above it)
NAIVE_MAX_LEN = 2048


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
# GQA attention (global)
# ===========================================================================
def attn_param_shapes(cfg: ModelConfig):
    """name → (shape, fan_in)."""
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {"wq": ((d, H, hd), d), "wk": ((d, KV, hd), d),
            "wv": ((d, KV, hd), d), "wo": ((H, hd, d), H * hd)}


def attn_cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": (batch, max_len, KV, hd), "v": (batch, max_len, KV, hd)}


def _project_qkv(params, x, cfg: ModelConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def attn_apply(params, x, *, cfg: ModelConfig, mode: str,
               cache: Optional[Cache] = None,
               positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Global causal GQA. ``positions``: the chunk offset (an int) in
    ``chunk`` mode, the new tokens' positions [B] in ``decode`` mode."""
    S = x.shape[1]
    if mode == "prefill":
        if S > NAIVE_MAX_LEN:
            raise NotImplementedError(
                f"prefill of {S} > {NAIVE_MAX_LEN} tokens needs blockwise "
                f"attention, which is not ported yet")
        q, k, v = _project_qkv(params, x, cfg,
                               torch.arange(S, device=x.device))
        o = naive_attention(q, k, v)
        return torch.einsum("bshk,hkd->bsd", o, params["wo"]), \
            {"k": k, "v": v}
    if mode == "chunk":
        return _attn_chunk(params, x, cfg=cfg, cache=cache, offset=positions)
    if mode != "decode":
        raise ValueError(f"attn_apply: unsupported mode {mode!r}")
    q, k_new, v_new = _project_qkv(params, x, cfg, positions[:, None])
    _write_new_token(cache["k"], k_new[:, 0], positions)
    _write_new_token(cache["v"], v_new[:, 0], positions)
    o = decode_attention(q[:, 0], cache["k"], cache["v"],
                         positions).to(q.dtype)
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
    """Expanded (per-head K/V) causal attention + output projection."""
    B, L, _ = ckv.shape
    H = cfg.num_heads
    k_nope = torch.einsum("bsr,rhk->bshk", ckv, params["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", ckv, params["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None].expand(
        B, L, H, cfg.mla.qk_rope_head_dim)], dim=-1)
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
    if mode == "prefill":
        pos = torch.arange(S, device=x.device)
        q_nope, q_rope, ckv, krope = _mla_qkv_latent(params, x, cfg, pos)
        y = _expand_attend(params, q_nope, q_rope, ckv, krope, cfg)
        return y, {"ckv": ckv, "krope": krope}
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
