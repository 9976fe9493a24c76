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
of the stacked superblock cache update the stack itself.

GQA and MLA take one code path on one device and on a mesh (``ctx``,
one process per rank; ``specs`` the layer's parameter specs as the rank
holds them), the reference's ``shard_map`` bodies; on one device every
collective is the identity and nothing is cut:
  * prefill / chunk / train: heads tensor-parallel over ``ctx.tp_axis`` — each
    rank holds its heads' ``wq``/``wk``/``wv``/``wo`` blocks, attends
    over them (``head_sharded``; a head count that does not divide the
    axis is padded first, K/V repeated per query head:
    ``_pad_heads_for_tp``), and the ``wo`` products are summed over the
    axis. The prefill cache keeps every KV head (all-gathered).
  * decode: the cache is this rank's batch block and, over
    ``ctx.seq_axis``, its block of slots (flash-decoding):
    :func:`decode_attention_distributed` writes the new token only on
    the rank that owns its slot, each rank computes the partial result
    over its slots (the decode-attention kernel's partial output for
    GQA; plain tensor code for MLA, as in the reference), and the
    partials combine by ``pmax`` then ``psum`` with log-sum-exp weights.
Cross-attention takes the same two layouts over the memory's K/V
(:func:`cross_attn_apply`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_partial)
from repro_torch.models.common import (apply_rope, blockwise_attention,
                                       naive_attention, rms_norm)
from repro_torch.models.mesh_ctx import make_smoke_ctx

Cache = Dict[str, torch.Tensor]
#: the context of one device: every collective the identity
ONE_DEVICE = make_smoke_ctx()
#: longest prompt the naive prefill attention takes (above it, blockwise
#: attention, as in the reference)
NAIVE_MAX_LEN = 2048


def _prefill_attention(q, k, v, window: int = 0):
    """Causal prefill attention, naive up to ``NAIVE_MAX_LEN`` tokens and
    blockwise above, as the reference picks. ``meta`` tensors (the dry
    run: shapes, no values, no memory held) take the naive form at any
    length: the same function and output shape, and blockwise only
    bounds the memory the scores take."""
    if q.shape[1] > NAIVE_MAX_LEN and q.device.type != "meta":
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
               positions: Optional[torch.Tensor] = None, ctx=None,
               specs=None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Causal GQA, global (``window == 0``) or over the last ``window``
    positions. ``positions``: the chunk offset (an int) in ``chunk``
    mode, the new tokens' positions [B] in ``decode`` mode. ``ctx`` /
    ``specs``: the mesh (default: one device) and the layer's parameter
    specs (see the module docstring)."""
    ctx = ONE_DEVICE if ctx is None else ctx
    qa, ka, wa = (_tp(ctx, specs, "wq", 1), _tp(ctx, specs, "wk", 1),
                  _tp(ctx, specs, "wo", 0))
    B, S, _ = x.shape
    if mode == "decode":
        q, k_new, v_new = _project_qkv(params, x, cfg, positions[:, None])
        if qa is not None:
            q = ctx.all_gather(q, qa, 2)
        if ka is not None:
            k_new = ctx.all_gather(k_new, ka, 2)
            v_new = ctx.all_gather(v_new, ka, 2)
        o = decode_attention_distributed(q, k_new, v_new, cache, positions,
                                         ctx, window=window)
        o = o.to(q.dtype)[:, None]
        if wa is not None:
            o = head_sharded(ctx, o)
        y = torch.einsum("bshk,hkd->bsd", o, params["wo"])
        return _tp_sum(y, ctx, wa), cache
    if mode == "chunk":
        if window:
            raise ValueError("chunked prefill needs global attention "
                             f"(window {window})")
        L = cache["k"].shape[1]
        offset = positions
        if offset + S > L:
            raise ValueError(f"chunk [{offset}, {offset + S}) exceeds "
                             f"buffer {L}")
        pos = offset + torch.arange(S, device=x.device)
    elif mode in ("prefill", "train"):
        pos = torch.arange(S, device=x.device)
    else:
        raise ValueError(f"attn_apply: unsupported mode {mode!r}")
    q, k, v = _project_qkv(params, x, cfg, pos)
    if ka is not None:        # the cache keeps every KV head
        k_all, v_all = ctx.all_gather(k, ka, 2), ctx.all_gather(v, ka, 2)
    else:
        k_all, v_all = k, v
    if mode == "chunk":
        # write the chunk's roped K/V into the buffer at ``offset`` (in
        # place), then attend causally over the whole buffer with
        # explicit position masks
        cache["k"][:, offset:offset + S] = k_all.to(cache["k"].dtype)
        cache["v"][:, offset:offset + S] = v_all.to(cache["v"].dtype)
        kk, vv = cache["k"], cache["v"]
        if ka is not None:
            kk, vv = head_sharded(ctx, kk), head_sharded(ctx, vv)
        ql, kl, vl, wo = _local_heads(q, kk, vv, params["wo"], ctx, qa, ka,
                                      wa)
        o = naive_attention(ql, kl, vl, q_positions=pos,
                            kv_positions=torch.arange(L, device=x.device))
        y = torch.einsum("bshk,hkd->bsd", o, wo)
        return _tp_sum(y, ctx, ctx.tp_axis), cache
    ql, kl, vl, wo = _local_heads(q, k, v, params["wo"], ctx, qa, ka, wa)
    o = _prefill_attention(ql, kl, vl, window)
    y = _tp_sum(torch.einsum("bshk,hkd->bsd", o, wo), ctx, ctx.tp_axis)
    if mode == "train":
        return y, None
    if window > 0 and S > window:
        # the trailing window, position p at ring slot p % window
        slots = (torch.arange(window, device=x.device)
                 + (S - window)) % window
        ring = {}
        for n, t in (("k", k_all), ("v", v_all)):
            ring[n] = torch.empty_like(t[:, :window])
            ring[n][:, slots] = t[:, S - window:]
        return y, ring
    return y, {"k": k_all, "v": v_all}


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
                     cache: Optional[Cache] = None, ctx=None, specs=None,
                     mem_axis=None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Attention of ``x`` over a memory, with no RoPE and no mask.
    ``prefill``: ``memory`` [B, M, md] → K/V, returned as the cache
    (``train``: no cache).
    ``decode``: the cache's K/V, read only; every slot is attended (the
    kernel at ``positions = L - 1``), the zero-padded ones of a memory
    shorter than the slot too, as the reference's ``naive_attention``
    attends them.

    On a mesh (``ctx`` / ``specs``, see the module docstring) the heads
    go over the TP axis as in :func:`attn_apply`, and ``memory`` and the
    cache are this rank's rows. The prefill cache keeps every slot and
    KV head (the prefill layout); the decode cache is this rank's block
    of the memory's slots over ``mem_axis`` where ``cache_pspecs`` cuts
    them (``Model.mem_axis``; None: uncut): each rank then runs the
    decode-attention kernel's partial output over its slots (every one
    valid) and the partials combine by log-sum-exp weights across the
    axis. An uncut memory (one whose
    length does not divide the axis: the VLM's 1601 patches) is read
    whole on every rank, each rank attending with its own heads."""
    ctx = ONE_DEVICE if ctx is None else ctx
    qa, ka, wa = (_tp(ctx, specs, "wq", 1), _tp(ctx, specs, "wk", 1),
                  _tp(ctx, specs, "wo", 0))
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if mode in ("prefill", "train"):
        if memory is None:
            raise ValueError(f"cross-attention {mode} needs the memory")
        k = torch.einsum("bmd,dhk->bmhk", memory, params["wk"])
        v = torch.einsum("bmd,dhk->bmhk", memory, params["wv"])
        ql, kl, vl, wo = _local_heads(q, k, v, params["wo"], ctx, qa, ka,
                                      wa)
        o = naive_attention(ql, kl, vl, causal=False)
        y = _tp_sum(torch.einsum("bshk,hkd->bsd", o, wo), ctx, ctx.tp_axis)
        if mode == "train":
            return y, None
        if ka is not None:        # the cache keeps every KV head
            k, v = ctx.all_gather(k, ka, 2), ctx.all_gather(v, ka, 2)
        return y, {"k": k, "v": v}
    if mode != "decode":
        raise ValueError(f"cross_attn_apply: unsupported mode {mode!r}")
    B, L = cache["k"].shape[:2]
    last = torch.full((B,), L - 1, dtype=torch.int32, device=x.device)
    if mem_axis is None or ctx.axis_size(mem_axis) == 1:
        ql, kl, vl, wo = _local_heads(q, cache["k"], cache["v"],
                                      params["wo"], ctx, qa, None, wa)
        o = decode_attention(ql[:, 0], kl, vl, last).to(q.dtype)
        y = torch.einsum("bshk,hkd->bsd", o[:, None], wo)
        return _tp_sum(y, ctx, ctx.tp_axis), cache
    if qa is not None:
        q = ctx.all_gather(q, qa, 2)
    acc, m, l = decode_attention_partial(q[:, 0], cache["k"], cache["v"],
                                         last)
    o = _lse_combine(acc, m, l, ctx, mem_axis).to(q.dtype)[:, None]
    if wa is not None:
        o = head_sharded(ctx, o)
    y = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return _tp_sum(y, ctx, wa), cache


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
    H = params["wk_b"].shape[1]            # this rank's heads on a mesh
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
              positions: Optional[torch.Tensor] = None, ctx=None,
              specs=None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """``positions``: the chunk offset (an int) in ``chunk`` mode, the
    new tokens' positions [B] in ``decode`` mode. ``ctx`` / ``specs``:
    the mesh (default: one device) and the layer's parameter specs (see
    the module docstring)."""
    ctx = ONE_DEVICE if ctx is None else ctx
    m = cfg.mla
    qa = _tp(ctx, specs, "wq_b", 1)
    if not (qa == _tp(ctx, specs, "wk_b", 1) == _tp(ctx, specs, "wv_b", 1)
            == _tp(ctx, specs, "wo", 0)):
        raise ValueError("MLA on a mesh: wq_b, wk_b, wv_b and wo must "
                         "share one head layout")
    B, S, _ = x.shape
    if mode in ("prefill", "train"):
        pos = torch.arange(S, device=x.device)
        q_nope, q_rope, ckv, krope = _mla_qkv_latent(params, x, cfg, pos)
        y = _expand_attend(params, q_nope, q_rope, ckv, krope, cfg)
        return _tp_sum(y, ctx, qa), ({"ckv": ckv, "krope": krope}
                                     if mode == "prefill" else None)
    if mode == "chunk":
        # write the chunk's latents into the buffer at ``offset`` (in
        # place), then attend over the whole buffer with explicit
        # position masks
        L = cache["ckv"].shape[1]
        offset = positions
        if offset + S > L:
            raise ValueError(f"chunk [{offset}, {offset + S}) exceeds "
                             f"buffer {L}")
        pos = offset + torch.arange(S, device=x.device)
        q_nope, q_rope, ckv, krope = _mla_qkv_latent(params, x, cfg, pos)
        cache["ckv"][:, offset:offset + S] = ckv.to(cache["ckv"].dtype)
        cache["krope"][:, offset:offset + S] = krope.to(
            cache["krope"].dtype)
        y = _expand_attend(params, q_nope, q_rope, cache["ckv"],
                           cache["krope"], cfg, q_positions=pos,
                           kv_positions=torch.arange(L, device=x.device))
        return _tp_sum(y, ctx, qa), cache
    if mode != "decode":
        raise ValueError(f"mla_apply: unsupported mode {mode!r}")
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_latent(
        params, x, cfg, positions[:, None])
    # absorbed: q' = q_nope · wk_b^T → latent-space scores against ckv
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["wk_b"])
    if qa is not None:
        q_lat = ctx.all_gather(q_lat, qa, 2)
        q_rope = ctx.all_gather(q_rope, qa, 2)
    o_lat = _mla_decode_distributed(
        q_lat, q_rope, ckv_new, krope_new, cache, positions, ctx,
        scale_dim=m.qk_nope_head_dim + m.qk_rope_head_dim)
    if qa is not None:
        o_lat = head_sharded(ctx, o_lat)
    o = torch.einsum("bshr,rhk->bshk", o_lat, params["wv_b"])
    y = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return _tp_sum(y, ctx, qa), cache


# ===========================================================================
# Heads and sequence shards (one process per rank; identities on one
# device)
# ===========================================================================
def _tp(ctx, specs, name: str, dim: int):
    """``ctx.tp_axis`` when this rank holds its block of ``name``'s dim
    ``dim`` over it (the heads of a weight), else None."""
    if specs is None or ctx.tp_size <= 1:
        return None
    return ctx.tp_axis if specs[name].entry(dim) == ctx.tp_axis else None


def _tp_sum(y, ctx, axis):
    """The tensor-parallel sum of partial outputs, in float32."""
    if axis is None or ctx.axis_size(axis) == 1:
        return y
    return ctx.psum(y.float(), axis).to(y.dtype)


def head_sharded(ctx, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of the heads of q/k/v/o [B, S, H, hd] over the
    TP axis when they divide it, else ``t`` (the reference pins the same
    layout with a sharding constraint)."""
    if ctx.tp_size <= 1 or t.shape[2] % ctx.tp_size:
        return t
    return ctx.take_block(t, 2, ctx.tp_axis)


def _pad_heads_for_tp(q, k, v, wo, tp: int):
    """A head count that does not divide the TP axis (Llama-4: 40 heads
    on 16): pad the query heads to the next multiple of ``tp`` and
    repeat K/V per query head (MHA), with zero ``wo`` rows for the pads,
    so the heads shard and the epilogue stays exact."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    Hp = -(-H // tp) * tp
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    pad = Hp - H
    if pad:
        def padh(t):
            return torch.nn.functional.pad(t, (0, 0, 0, pad))
        q, k, v = padh(q), padh(k), padh(v)
        wo = torch.nn.functional.pad(wo, (0, 0, 0, 0, 0, pad))
    return q, k, v, wo


def _local_heads(q, k, v, wo, ctx, qa, ka, wa):
    """q [B, S, ·, hd], k/v [B, L, ·, hd], wo [·, hd, d] as this rank
    holds them (``qa``/``ka``/``wa``: the TP axis where the heads are
    its block, else None) → this rank's query heads, the K/V each of
    them reads, and their ``wo`` rows."""
    n, tp = ctx.tp_size, ctx.tp_axis
    if n == 1:
        return q, k, v, wo
    if qa is None and q.shape[2] % n:
        if ka is not None:
            k, v = ctx.all_gather(k, tp, 2), ctx.all_gather(v, tp, 2)
        if wa is not None:
            wo = ctx.all_gather(wo, tp, 0)
        q, k, v, wo = _pad_heads_for_tp(q, k, v, wo, n)
        return (head_sharded(ctx, q), head_sharded(ctx, k),
                head_sharded(ctx, v), ctx.take_block(wo, 0, tp))
    if qa is None:
        q = head_sharded(ctx, q)
    if wa is None:
        wo = ctx.take_block(wo, 0, tp)
    if ka is None:
        # every KV head is here: give each local query head its own
        Hl = q.shape[2]
        G = Hl * n // k.shape[2]
        h0 = ctx.axis_index(tp) * Hl
        if Hl % G == 0:
            k = k[:, :, h0 // G:(h0 + Hl) // G]
            v = v[:, :, h0 // G:(h0 + Hl) // G]
        else:
            idx = torch.div(h0 + torch.arange(Hl, device=k.device), G,
                            rounding_mode="floor")
            k, v = k.index_select(2, idx), v.index_select(2, idx)
    return q, k, v, wo


def _seq_block(ctx, L_local: int):
    """(seq axis or None, first global slot of this rank's block): the
    decode cache is this rank's block of slots over ``ctx.seq_axis``
    whenever ``shard_kv_seq`` and the axis has more than one rank."""
    if not ctx.shard_kv_seq or ctx.axis_size(ctx.seq_axis) <= 1:
        return None, 0
    return ctx.seq_axis, ctx.axis_index(ctx.seq_axis) * L_local


def _local_slots(ctx, L_local: int):
    """(seq axis or None, ``local``): :func:`_seq_block`'s axis, and
    ``local(t)``, a global slot or position ``t`` counted from this
    rank's first slot."""
    axis, s0 = _seq_block(ctx, L_local)
    return axis, ((lambda t: t) if axis is None else (lambda t: t - s0))


def _lse_combine(acc, m, l, ctx, axis):
    """Partials (acc [B, H, r] f32 unnormalised, m, l [B, H]) of the
    ranks of ``axis`` → the normalised output: weights exp(m - max_m),
    summed over the axis."""
    if axis is not None:
        gm = ctx.pmax(m, axis)
        w = torch.exp(m - gm)
        acc = ctx.psum(acc * w[..., None], axis)
        l = ctx.psum(l * w, axis)
    return acc / torch.clamp(l[..., None], min=1e-30)


def decode_attention_distributed(q, k_new, v_new, cache: Cache, positions,
                                 ctx, *, window: int = 0):
    """q [B, 1, H, hd] (every head), k_new / v_new [B, 1, KV, hd] (every
    KV head); ``cache`` k/v [B, L_local, KV, hd], this rank's block of
    slots over the sequence axis; positions [B] the new token's. The new
    token is written (in place) only by the rank that owns its slot
    (``positions % window`` with a ring); each rank computes the partial
    result over its slots with the decode-attention kernel, and the
    partials combine across the axis by log-sum-exp weights. → [B, H,
    hd] f32. A ring's slot holds a position at most ``pos`` exactly when
    its global index is at most ``pos`` (slots < window), so a rank's
    block is attended as a global cache at ``positions - first slot``."""
    L_loc = cache["k"].shape[1]
    axis, local = _local_slots(ctx, L_loc)
    slot = torch.remainder(positions, window) if window > 0 else positions
    _write_new_token(cache["k"], k_new[:, 0], local(slot))
    _write_new_token(cache["v"], v_new[:, 0], local(slot))
    if axis is None:
        return decode_attention(q[:, 0], cache["k"], cache["v"], positions,
                                window=window)
    acc, m, l = decode_attention_partial(q[:, 0], cache["k"], cache["v"],
                                         local(positions))
    return _lse_combine(acc, m, l, ctx, axis)


def _mla_decode_distributed(q_lat, q_rope, ckv_new, krope_new, cache: Cache,
                            positions, ctx, scale_dim: int):
    """Absorbed MLA decode, flash-decoding over this rank's block of the
    latent cache: each row's new latents written in place at its
    position where this rank owns the slot (a row whose position lies
    outside the block keeps it unchanged), the partial softmax over the
    local slots ``<= position`` (plain tensor code, as in the
    reference), combined over the sequence axis by log-sum-exp weights.
    → [B, 1, H, r]."""
    ckv_c, krope_c = cache["ckv"], cache["krope"]
    L_loc = ckv_c.shape[1]
    axis, local = _local_slots(ctx, L_loc)
    scale = 1.0 / np.sqrt(scale_dim)
    pos = local(positions)
    _write_new_token(ckv_c, ckv_new[:, 0], pos)
    _write_new_token(krope_c, krope_new[:, 0], pos)
    valid = torch.arange(L_loc, device=positions.device)[None, :] \
        <= pos[:, None]
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
    out = _lse_combine(acc, mx, l, ctx, axis)[:, None]
    return out.to(q_lat.dtype)
