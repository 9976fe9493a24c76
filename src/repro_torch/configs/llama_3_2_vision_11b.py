"""llama-3.2-vision-11b — VLM with cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision]. 40 decoder layers, d_model=4096,
32 heads GQA kv=8, d_ff=14336, vocab=128256. Every 5th layer is a
cross-attention layer attending to vision-patch embeddings. Per the
assignment carve-out, the ViT vision encoder + projector is a STUB —
``input_specs`` supplies precomputed patch embeddings of shape
(batch, num_frontend_tokens, d_model); we implement the language decoder.
"""
from repro_torch.configs.base import ATTN, CROSS_ATTN, MLP, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    layer_pattern=(
        (ATTN, MLP), (ATTN, MLP), (ATTN, MLP), (ATTN, MLP),
        (CROSS_ATTN, MLP),
    ),
    cross_attn_every=5,
    num_frontend_tokens=1601,  # one 448px image tile -> 1601 patch embeddings
    rope_theta=500000.0,
    dtype="bfloat16",
)
