"""recurrentgemma-2b — hybrid RG-LRU + local attention, ratio 2:1.

[arXiv:2402.19427] (Griffin / RecurrentGemma). 26 layers, d_model=2560,
10 heads with GQA kv=1 (MQA), d_ff=7680, vocab=256000. The Griffin pattern
is (recurrent, recurrent, local-attention) repeated; 26 = 8*3 + 2 so the
final two layers are recurrent (unrolled tail).
"""
from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MLP, RGLRU, ModelConfig,
                                RGLRUConfig)

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=((RGLRU, MLP), (RGLRU, MLP), (LOCAL_ATTN, MLP)),
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, window=2048),
    sliding_window=2048,
    rope_theta=10000.0,
    attn_logit_softcap=0.0,
    tie_embeddings=True,
    dtype="bfloat16",
)
