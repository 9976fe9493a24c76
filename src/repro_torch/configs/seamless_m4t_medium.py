"""seamless-m4t-medium — encoder-decoder, multimodal (speech/text).

[arXiv:2308.11596]. Transformer backbone only: 12 encoder layers +
12 decoder layers, d_model=1024, 16 heads (kv=16 — MHA), d_ff=4096,
vocab=256206. The mel-spectrogram + conv feature extractor frontend is a
STUB per the assignment carve-out: ``input_specs`` supplies precomputed
frame embeddings (batch, num_frontend_tokens, d_model) consumed by the
transformer encoder.

Each decoder layer = self-attention block + cross-attention+FFN block,
so the decoder stack is expressed as 24 blocks with a 2-block pattern.
"""
from repro_torch.configs.base import ATTN, CROSS_ATTN, MLP, NONE, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=24,                      # 24 blocks == 12 decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    layer_pattern=((ATTN, NONE), (CROSS_ATTN, MLP)),
    encoder_layers=12,
    encoder_d_model=1024,
    num_frontend_tokens=512,            # ~10 s of audio frames after conv stack
    rope_theta=10000.0,
    dtype="bfloat16",
)
