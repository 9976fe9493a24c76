"""deepseek-v3-671b — the paper's own flagship model (MLA + MoE + MTP).

[DeepSeek-V3 technical report; served by xDeepServe §5.2/§7]. 61 layers,
d_model=7168, 128 MLA heads, 256 routed experts + 1 shared, top-8,
expert d_ff=2048, dense d_ff=18432 (first 3 layers dense), vocab=129280,
one MTP layer. The paper deploys it as EP288 (256 routed + 32 shared
replicas) with MLA attention at TP=1.
"""
from repro_torch.configs.base import (MLA_ATTN, MLP, MOE, MLAConfig, ModelConfig,
                                MoEConfig)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437 (DeepSeek-V3); xDeepServe paper §5.2",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,       # MLA: latent cache, kv head count unused
    head_dim=128,
    d_ff=18432,
    vocab_size=129280,
    prefix_layers=((MLA_ATTN, MLP), (MLA_ATTN, MLP), (MLA_ATTN, MLP)),
    layer_pattern=((MLA_ATTN, MOE),),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(
        num_experts=256,
        num_shared_experts=1,
        top_k=8,
        expert_d_ff=2048,
        shared_d_ff=2048,
        capacity_factor=1.25,
        redundancy_slots=1,
    ),
    mtp_num_layers=1,
    rope_theta=10000.0,
    dtype="bfloat16",
)
