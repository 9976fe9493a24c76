"""KV-cache INT8 quantization (§4.7).

MLA's cache has a RoPE part and a non-RoPE (latent) part; the latent rows
have stable distributions and are quantized to INT8 with one scale per
row, while the RoPE part stays bf16. A GQA cache is quantized per
(position, head). The rows go through the quant-dispatch kernel on the
card; for low-sensitivity layers the attention scores themselves can be
computed in INT8.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.quant_dispatch.ops import fused_quantize


def quantize_kv_entry(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., d] cache rows → (int8 values, f32 scale per row)."""
    q, s = fused_quantize(x.reshape(-1, x.shape[-1]))
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def dequantize_kv_entry(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def quantize_mla_cache(cache: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """MLA cache {'ckv', 'krope'} → latent INT8, RoPE part unchanged."""
    q, s = quantize_kv_entry(cache["ckv"])
    return {"ckv_q": q, "ckv_scale": s, "krope": cache["krope"]}


def dequantize_mla_cache(qcache: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    return {"ckv": dequantize_kv_entry(qcache["ckv_q"], qcache["ckv_scale"])
            .to(qcache["krope"].dtype),
            "krope": qcache["krope"]}


def quantize_gqa_cache(cache: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """GQA k/v cache → INT8 per (position, head)."""
    out = {}
    for name in ("k", "v"):
        q, s = quantize_kv_entry(cache[name])
        out[name + "_q"], out[name + "_scale"] = q, s
    return out


def dequantize_gqa_cache(qcache: Dict[str, torch.Tensor],
                         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    return {name: dequantize_kv_entry(qcache[name + "_q"],
                                      qcache[name + "_scale"]).to(dtype)
            for name in ("k", "v")}


def int8_attention_scores(q_int8: torch.Tensor, q_scale: torch.Tensor,
                          k_int8: torch.Tensor, k_scale: torch.Tensor
                          ) -> torch.Tensor:
    """Fully-INT8 scores for low-sensitivity layers: q [B, H, d] ·
    k [B, L, H, d] with exact integer sums, rescaled to f32 [B, H, L].
    The scales broadcast as the reference broadcasts them: ``q_scale``
    [B, H], ``k_scale`` [B, H] (one per batch row and head, i.e. k
    quantized per head over all positions). The sums are taken in float64,
    exact for ``127² d < 2⁵³`` (PyTorch has no integer product for CUDA
    tensors)."""
    acc = torch.einsum("bhd,blhd->bhl", q_int8.double(), k_int8.double())
    return (acc.float() * q_scale[..., None]
            * k_scale[:, None].permute(0, 2, 1))


def memory_saving(cache_bytes_bf16: int) -> Tuple[int, float]:
    """INT8 latent halves the cache: returns (bytes, ratio)."""
    q_bytes = cache_bytes_bf16 // 2 + cache_bytes_bf16 // 256  # + scales
    return q_bytes, q_bytes / cache_bytes_bf16
