"""granite-8b — dense llama-architecture code model.

[arXiv:2405.04324] (IBM Granite Code). 36 layers, d_model=4096,
32 heads GQA kv=8, d_ff=14336, vocab=49152.
"""
from repro_torch.configs.base import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    layer_pattern=((ATTN, MLP),),
    rope_theta=10000000.0,
    dtype="bfloat16",
)
