"""internlm2-1.8b — dense GQA.

[arXiv:2403.17297]. 24 layers, d_model=2048, 16 heads GQA kv=8,
d_ff=8192, vocab=92544.
"""
from repro_torch.configs.base import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    source="arXiv:2403.17297",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    layer_pattern=((ATTN, MLP),),
    rope_theta=1000000.0,
    dtype="bfloat16",
)
