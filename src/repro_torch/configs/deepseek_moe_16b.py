"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed, top-6.

[arXiv:2401.06066]. 28 layers, d_model=2048, 16 heads (kv=16 — MHA),
expert d_ff=1408 (fine-grained), dense first layer d_ff=10944,
vocab=102400. The first layer is a dense MLP (prefix layer); the
remaining 27 are MoE.
"""
from repro_torch.configs.base import ATTN, MLP, MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,            # the dense prefix layer's FFN
    vocab_size=102400,
    prefix_layers=((ATTN, MLP),),
    layer_pattern=((ATTN, MOE),),
    moe=MoEConfig(
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        expert_d_ff=1408,
        shared_d_ff=1408,
        capacity_factor=1.5,
        redundancy_slots=1,
    ),
    rope_theta=10000.0,
    dtype="bfloat16",
)
