"""Transformerless (§5): the transformer decomposed into modular units.

The architecture breaks a transformer into independently placeable,
independently scalable units — Attention, FFN, MoE — connected by XCCL
primitives instead of living inside one monolithic program:

    AttentionUnit:  norms, QKV, cache read/write, output projection,
                    gating (router logits) — stateful (KV), scales with
                    sequence length × batch.
    MoEUnit:        expert FFNs — stateless, scales with token count.
    FFNUnit:        dense FFN — stateless.

In PyTorch each unit is a stage function on CUDA tensors, composed by a
host-side dataflow: calling a stage queues its kernels on the stream and
returns at once, so a driver issues one unit after another without
waiting for the card. This module defines the unit abstraction and the
partition planner that sizes a disaggregated deployment from a
``ModelConfig``; ``pd_disagg.py`` and ``moe_attn_disagg.py`` are the two
production deployments. Both functions here are pure Python.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.configs.base import MOE, ModelConfig


@dataclasses.dataclass
class UnitSpec:
    """A placeable module: its kind, parameter subtree selector, and its
    scaling characteristics."""
    name: str
    kind: str                     # "attention" | "ffn" | "moe"
    layer: int
    params_path: Tuple[str, ...]
    flops_per_token: float
    bytes_state_per_token: float  # KV bytes (0 for stateless units)

    @property
    def stateless(self) -> bool:
        return self.bytes_state_per_token == 0.0


def split_model(cfg: ModelConfig) -> List[UnitSpec]:
    """Decompose a config into Transformerless units with their scaling
    characteristics (used by the partition planner)."""
    units: List[UnitSpec] = []
    d, hd = cfg.d_model, cfg.resolved_head_dim
    for i, (mixer, ffn) in enumerate(cfg.layer_kinds()):
        attn_flops = 2.0 * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd \
            + 2.0 * cfg.num_heads * hd * d
        kv_bytes = 2.0 * cfg.num_kv_heads * hd * 2  # k+v, bf16
        units.append(UnitSpec(f"L{i}.{mixer}", "attention", i,
                              ("blocks",), attn_flops, kv_bytes))
        if ffn == MOE:
            e = cfg.moe
            moe_flops = 6.0 * d * e.expert_d_ff * e.top_k
            units.append(UnitSpec(f"L{i}.moe", "moe", i, ("blocks",),
                                  moe_flops, 0.0))
        elif ffn != "none":
            units.append(UnitSpec(f"L{i}.ffn", "ffn", i, ("blocks",),
                                  6.0 * d * cfg.d_ff, 0.0))
    return units


@dataclasses.dataclass
class PartitionPlan:
    """How many dies each unit class gets (the paper's 288/480 split)."""
    n_attention: int
    n_expert: int
    n_dp_domains: int
    dp_groups_per_domain: int
    microbatches: int

    @property
    def total(self) -> int:
        return self.n_attention + self.n_expert


def plan_partition(cfg: ModelConfig, total_dies: int,
                   decode_batch_per_die: int = 96,
                   mean_seq_len: int = 4096) -> PartitionPlan:
    """Balance attention vs MoE dies for the decode stage.

    MoE compute scales with batch; attention with batch × sequence. For
    DeepSeek-R1-class models on 768 dies the paper lands on 288 MoE + 480
    attention in 3 DP domains × 160 groups with 2 microbatches; this
    planner reproduces that split from first principles: provision expert
    dies ∝ active-expert FLOPs and attention dies ∝ attention FLOPs at the
    target batch/sequence point, with the expert count as a lower bound
    (≥1 die per expert incl. shared replicas — EP288 = 256+32)."""
    e = cfg.moe
    d = cfg.d_model
    # per-token FLOPs
    moe_f = 6.0 * d * e.expert_d_ff * max(e.top_k, 1) \
        + 6.0 * d * (e.shared_d_ff or e.expert_d_ff) * e.num_shared_experts
    if cfg.mla is not None:
        m = cfg.mla
        H = cfg.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        # MLAProlog (projections, absorbed form) ≈ 2 × attention params
        prolog_params = (d * m.q_lora_rank + m.q_lora_rank * H * qk
                         + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                         + 2 * m.kv_lora_rank * H * m.qk_nope_head_dim
                         + H * m.v_head_dim * d)
        attn_f = 2.0 * prolog_params
        # latent attention: scores against [ckv;krope], context over ckv
        attn_f += 2.0 * H * mean_seq_len * (
            2 * m.kv_lora_rank + m.qk_rope_head_dim)
    else:
        hd = cfg.resolved_head_dim
        attn_f = (2.0 * d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                  + 2.0 * mean_seq_len * cfg.num_kv_heads * hd * 2)
    min_expert = e.num_experts + (32 if e.num_shared_experts else 0) \
        if e.enabled else 0
    frac_moe = moe_f / max(moe_f + attn_f, 1e-9)
    n_expert = max(int(round(total_dies * frac_moe)), min_expert)
    n_expert = min(n_expert, total_dies // 2 + min_expert)
    n_attn = total_dies - n_expert
    # DP domains: enough that while one domain occupies the expert dies
    # the others keep computing attention (paper: 3 domains × 160 groups).
    n_domains = max(1, min(4, round((attn_f + moe_f) / max(moe_f, 1e-9))))
    while n_attn % n_domains:
        n_domains -= 1
    return PartitionPlan(
        n_attention=n_attn,
        n_expert=n_expert,
        n_dp_domains=n_domains,
        dp_groups_per_domain=n_attn // n_domains,
        microbatches=2,
    )
