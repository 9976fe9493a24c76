"""llama4-maverick-400b-a17b — MoE, 128 routed experts, top-1 routing.

[hf:meta-llama/Llama-4-Scout-17B-16E family / Llama-4 Maverick card].
48 layers, d_model=5120, 40 heads GQA kv=8, expert d_ff=8192,
vocab=202048, 128 experts top-1 plus one always-on shared expert
(Llama-4 style "early fusion" MoE). Maverick interleaves dense and MoE
FFN layers 1:1, which is what yields ~400B total / 17B active params.
"""
from repro_torch.configs.base import ATTN, MLP, MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=((ATTN, MLP), (ATTN, MOE)),
    moe=MoEConfig(
        num_experts=128,
        num_shared_experts=1,
        top_k=1,
        expert_d_ff=8192,
        shared_d_ff=8192,
        capacity_factor=1.25,
        redundancy_slots=1,
    ),
    rope_theta=500000.0,
    dtype="bfloat16",
)
