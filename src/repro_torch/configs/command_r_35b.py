"""command-r-35b — dense GQA, no biases.

[hf:CohereForAI/c4ai-command-r-v01]. 40 layers, d_model=8192, 64 heads
GQA kv=8, d_ff=22528, vocab=256000.
"""
from repro_torch.configs.base import ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    layer_pattern=((ATTN, MLP),),
    qkv_bias=False,
    rope_theta=8000000.0,
    tie_embeddings=True,
    dtype="bfloat16",
)
