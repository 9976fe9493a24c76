"""mistral-nemo-12b — dense, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407]. 40 layers, d_model=5120, 32 heads
(head_dim=128, GQA kv=8), d_ff=14336, vocab=131072.
"""
from repro_torch.configs.base import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    layer_pattern=((ATTN, MLP),),
    rope_theta=1000000.0,
    dtype="bfloat16",
)
