"""Config dataclasses for the repro framework.

Every assigned architecture is expressed as a :class:`ModelConfig`. The
config is the single source of truth consumed by ``models.build_model``,
the launcher, the dry-run, and the serving engine.

Design notes
------------
* ``layer_pattern`` describes the per-layer block kind. The transformer
  assembly scans over repeating "superblocks" (the pattern) and unrolls the
  remainder, which keeps compile time low for 24-48 layer models while
  supporting heterogeneous stacks (Griffin's 2:1 recurrent:attention, VLM
  cross-attention every Nth layer, DeepSeek's leading dense MLP layer).
* Reduced "smoke" variants (≤2 pattern repeats, d_model ≤ 512, ≤4 experts)
  are derived mechanically by :func:`smoke_variant` so smoke tests always
  exercise the same code path as the full config.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Block kinds appearing in layer patterns.
# ---------------------------------------------------------------------------
ATTN = "attn"               # global self attention (GQA / MHA)
LOCAL_ATTN = "local_attn"   # sliding-window self attention
MLA_ATTN = "mla"            # DeepSeek multi-head latent attention
RGLRU = "rglru"             # RecurrentGemma / Griffin RG-LRU recurrent block
SSM = "ssm"                 # Mamba-2 SSD block
CROSS_ATTN = "cross_attn"   # attend to encoder/vision memory (decoder side)

MLP = "mlp"                 # dense FFN
MOE = "moe"                 # mixture of experts FFN
NONE = "none"               # no FFN half (mamba blocks fuse everything)

VALID_SEQ_MIXERS = {ATTN, LOCAL_ATTN, MLA_ATTN, RGLRU, SSM, CROSS_ATTN}
VALID_FFNS = {MLP, MOE, NONE}


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (paper §3.2, §4.5)."""
    num_experts: int = 0            # routed experts
    num_shared_experts: int = 0     # always-on shared experts (DeepSeek-MoE)
    top_k: int = 1
    expert_d_ff: int = 0            # per-expert hidden dim
    shared_d_ff: int = 0            # shared-expert hidden dim (0 → expert_d_ff)
    capacity_factor: float = 1.25   # for capacity-based dispatch
    router_aux_coef: float = 0.01   # load-balance loss coefficient (train)
    router_z_coef: float = 1e-3
    # EPLB: redundant expert slots per EP rank (paper §4.5 reserves slots)
    redundancy_slots: int = 1

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD settings [arXiv:2405.21060]."""
    state_dim: int = 128            # N: SSM state size
    head_dim: int = 64              # P: channels per SSD head
    num_heads: int = 0              # derived if 0: d_inner // head_dim
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256           # SSD block-diagonal chunk length


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent block settings [arXiv:2402.19427]."""
    lru_width: int = 0              # 0 → d_model
    conv_width: int = 4
    window: int = 2048              # local attention window of the hybrid


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention [DeepSeek-V3 TR]."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                # citation (paper / model card)

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0               # 0 → d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # layer pattern: tuple of (seq_mixer, ffn) pairs; tiled to num_layers.
    layer_pattern: Tuple[Tuple[str, str], ...] = ((ATTN, MLP),)
    # explicit leading layers that are NOT part of the scanned pattern
    # (e.g. deepseek's first dense layer).
    prefix_layers: Tuple[Tuple[str, str], ...] = ()

    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    rglru: RGLRUConfig = field(default_factory=RGLRUConfig)
    mla: Optional[MLAConfig] = None

    # attention details
    rope_theta: float = 10000.0
    sliding_window: int = 0          # used by LOCAL_ATTN blocks
    long_context_window: int = 4096  # window substituted for ATTN at long_500k
    attn_logit_softcap: float = 0.0
    qkv_bias: bool = False           # command-r: no bias; internlm2: no bias
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # enc-dec (audio) / vlm
    encoder_layers: int = 0          # >0 → encoder-decoder model
    encoder_d_model: int = 0         # 0 → d_model
    cross_attn_every: int = 0        # vlm: a CROSS_ATTN block every N layers
    num_frontend_tokens: int = 64    # stubbed modality frontend output length

    # MTP speculative decoding head (paper §4.6)
    mtp_num_layers: int = 0

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        for mixer, ffn in self.layer_pattern + self.prefix_layers:
            if mixer not in VALID_SEQ_MIXERS:
                raise ValueError(f"unknown seq mixer {mixer!r}")
            if ffn not in VALID_FFNS:
                raise ValueError(f"unknown ffn kind {ffn!r}")
        if self.family == "moe" and not self.moe.enabled:
            raise ValueError("moe family requires moe.num_experts > 0")

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_pattern_layers(self) -> int:
        return self.num_layers - len(self.prefix_layers)

    @property
    def num_superblocks(self) -> int:
        """Number of scanned repetitions of ``layer_pattern``."""
        return self.num_pattern_layers // self.pattern_len

    @property
    def num_tail_layers(self) -> int:
        """Pattern-layers that do not fill a whole superblock (unrolled)."""
        return self.num_pattern_layers % self.pattern_len

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def has_moe(self) -> bool:
        return any(f == MOE for _, f in self.layer_pattern + self.prefix_layers)

    @property
    def is_attention_free(self) -> bool:
        return not any(
            m in (ATTN, LOCAL_ATTN, MLA_ATTN, CROSS_ATTN)
            for m, _ in self.layer_pattern + self.prefix_layers
        )

    @property
    def supports_long_context(self) -> bool:
        """True if the arch natively avoids O(seq) KV growth per layer."""
        return all(
            m in (RGLRU, SSM, LOCAL_ATTN)
            for m, _ in self.layer_pattern + self.prefix_layers
            if m != CROSS_ATTN
        )

    def layer_kinds(self) -> Tuple[Tuple[str, str], ...]:
        """The fully unrolled (mixer, ffn) list, length == num_layers."""
        out = list(self.prefix_layers)
        for i in range(self.num_pattern_layers):
            out.append(self.layer_pattern[i % self.pattern_len])
        return tuple(out)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d                          # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                     # lm head
        for mixer, ffn in self.layer_kinds():
            if mixer in (ATTN, LOCAL_ATTN, CROSS_ATTN):
                n += d * (self.num_heads * hd)           # q
                n += 2 * d * (self.num_kv_heads * hd)    # k, v
                n += (self.num_heads * hd) * d           # o
            elif mixer == MLA_ATTN and self.mla is not None:
                m = self.mla
                n += d * m.q_lora_rank + m.q_lora_rank * self.num_heads * (
                    m.qk_nope_head_dim + m.qk_rope_head_dim)
                n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                n += m.kv_lora_rank * self.num_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                n += self.num_heads * m.v_head_dim * d
            elif mixer == RGLRU:
                w = self.rglru.lru_width or d
                n += 2 * d * w + w * d + 3 * w           # in/out proj + gates
            elif mixer == SSM:
                di = self.ssm.expand * d
                n += d * 2 * di + di * d                 # in/out proj
                n += di * 2 * self.ssm.state_dim         # B, C proj (approx)
            if ffn == MLP:
                n += 3 * d * self.d_ff                   # gate/up/down
            elif ffn == MOE:
                e = self.moe
                n += e.num_experts * 3 * d * e.expert_d_ff
                n += e.num_shared_experts * 3 * d * (e.shared_d_ff or e.expert_d_ff)
                n += d * e.num_experts                   # router
            n += 2 * d                                   # norms
        if self.is_encdec:
            # encoder layers: self-attn + mlp, same dims
            per = 4 * d * (self.num_heads * hd) // 2  # rough: q,k,v,o at enc dims
            ed = self.encoder_d_model or d
            per = 2 * ed * (self.num_heads * hd) + 2 * ed * (self.num_kv_heads * hd) \
                + 3 * ed * self.d_ff + 2 * ed
            n += self.encoder_layers * per
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE counts top_k + shared only)."""
        if not self.has_moe:
            return self.param_count()
        e = self.moe
        full_moe = e.num_experts * 3 * self.d_model * e.expert_d_ff
        active_moe = e.top_k * 3 * self.d_model * e.expert_d_ff
        n_moe_layers = sum(1 for _, f in self.layer_kinds() if f == MOE)
        return self.param_count() - n_moe_layers * (full_moe - active_moe)


# ---------------------------------------------------------------------------
def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Mechanically reduce a config for CPU smoke tests.

    Guarantees: ≤2 superblocks worth of layers (plus prefix), d_model ≤ 512,
    ≤4 experts, vocab ≤ 512 — but the SAME family/pattern/code path.
    """
    pat = cfg.layer_pattern
    n_layers = len(cfg.prefix_layers) + len(pat)  # prefix + one superblock
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    if heads % kv:
        kv = 1
    moe = cfg.moe
    if moe.enabled:
        moe = replace(
            moe,
            num_experts=min(moe.num_experts, 4),
            num_shared_experts=min(moe.num_shared_experts, 1),
            top_k=min(moe.top_k, 2),
            expert_d_ff=min(moe.expert_d_ff or 128, 128),
            shared_d_ff=min(moe.shared_d_ff or 128, 128),
            # effectively dropless: smoke tests assert prefill/decode parity,
            # which capacity drops (untrained, skewed router) would break.
            capacity_factor=8.0,
        )
    mla = cfg.mla
    if mla is not None:
        mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                        qk_nope_head_dim=32, qk_rope_head_dim=16,
                        v_head_dim=32)
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=min(cfg.resolved_head_dim, 64),
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        moe=moe,
        mla=mla,
        ssm=replace(cfg.ssm, state_dim=min(cfg.ssm.state_dim, 32),
                    head_dim=min(cfg.ssm.head_dim, 32), chunk_size=32),
        rglru=replace(cfg.rglru, lru_width=0, window=64),
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_d_model=min(cfg.encoder_d_model or 0, 256),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        long_context_window=256,
        num_frontend_tokens=16,
        mtp_num_layers=min(cfg.mtp_num_layers, 1),
    )


# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
