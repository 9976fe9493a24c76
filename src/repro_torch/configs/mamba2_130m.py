"""mamba2-130m — attention-free SSM with state-space duality (SSD).

[arXiv:2405.21060]. 24 layers, d_model=768, ssm_state=128, vocab=50280,
no attention, no separate FFN (the Mamba block fuses mixing + gating).
"""
from repro_torch.configs.base import NONE, SSM, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=24,
    d_model=768,
    num_heads=24,          # SSD heads: d_inner(1536) / head_dim(64)
    num_kv_heads=24,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=((SSM, NONE),),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    tie_embeddings=True,
    dtype="bfloat16",
)
