"""The transformer stack, with the reference's parameter and cache layout.

A model is a stack of blocks, each (sequence mixer, FFN) with pre-norms
and residual connections, split into:

  * ``prefix`` — explicit leading blocks (DeepSeek's dense layers), a
    tuple of per-layer dicts;
  * ``blocks`` — ``n_sb`` repetitions of ``cfg.layer_pattern``, each
    leaf stacked on a leading ``[n_sb, ...]`` axis (the reference scans
    over it; here a Python loop walks it).

Parameters are nested dicts of tensors whose paths and shapes equal the
JAX package's ``Model.init`` leaves, so ``models/weights.py`` can carry
weights across one to one. The port runs global GQA (``ATTN``) and MLA
mixers with MLP or MoE FFNs, decoder-only, with no unrolled tail after
the superblocks, and the §4.6 MTP draft head (``mtp``: one (mixer, MLP)
block behind a projection of [norm(hidden); norm(embedding)]); the
encoder, the tail and the other mixers (sliding-window, cross-attention,
SSM, RG-LRU) wait.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ATTN, MLA_ATTN, MLP, MOE, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models.common import (dense_init, dtype_of, embed_init,
                                       resolve_device, rms_norm, tree_map)

PyTree = Any


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str                 # "dense" | "embed" | "zeros"
    fan_in: int = 0


def _index(tree, i):
    return tree_map(lambda t: t[i], tree)


# ===========================================================================
# Single block
# ===========================================================================
def block_spec(cfg: ModelConfig, kind, dtype) -> Dict[str, PyTree]:
    mixer, ffn = kind
    d = cfg.d_model
    norm = ParamSpec((d,), torch.float32, "zeros")
    spec: Dict[str, PyTree] = {"mixer_norm": norm}
    shapes = (A.attn_param_shapes(cfg) if mixer == ATTN
              else A.mla_param_shapes(cfg))
    spec["mixer"] = {
        n: (ParamSpec(s, torch.float32, "zeros") if fan is None
            else ParamSpec(s, dtype, "dense", fan))
        for n, (s, fan) in shapes.items()}

    def mlp(f):
        return {"wi_gate": ParamSpec((d, f), dtype, "dense", d),
                "wi_up": ParamSpec((d, f), dtype, "dense", d),
                "wo": ParamSpec((f, d), dtype, "dense", f)}
    if ffn == MLP:
        spec["ffn_norm"] = norm
        spec["ffn"] = mlp(cfg.d_ff)
    elif ffn == MOE:
        e = cfg.moe
        E, fe = e.num_experts, e.expert_d_ff
        spec["ffn_norm"] = norm
        spec["ffn"] = {
            "router": ParamSpec((d, E), torch.float32, "dense", d),
            "we_gate": ParamSpec((E, d, fe), dtype, "dense", d),
            "we_up": ParamSpec((E, d, fe), dtype, "dense", d),
            "we_down": ParamSpec((E, fe, d), dtype, "dense", fe),
        }
        if e.num_shared_experts:
            spec["ffn"]["shared"] = mlp(
                (e.shared_d_ff or e.expert_d_ff) * e.num_shared_experts)
    return spec


def block_apply(params, x, *, cfg: ModelConfig, kind, mode: str,
                cache=None, positions=None, placement=None,
                decode_microbatches: int = 1):
    """Returns (x_out, layer cache). ``placement``: this layer's EPLB
    slice ``(replica_slots, n_replicas, phys_owner)`` or None;
    ``decode_microbatches``: the §4.4 ping-pong split of a decode MoE
    batch (1 = off; ``moe_apply`` applies it at decode only), as
    ``MeshCtx.decode_microbatches`` in the reference."""
    mixer, ffn = kind
    h = rms_norm(x, params["mixer_norm"], cfg.norm_eps)
    apply = A.attn_apply if mixer == ATTN else A.mla_apply
    y, new_cache = apply(params["mixer"], h, cfg=cfg, mode=mode, cache=cache,
                         positions=positions)
    x = x + y
    if ffn == MLP:
        h = rms_norm(x, params["ffn_norm"], cfg.norm_eps)
        x = x + F.mlp_apply(params["ffn"], h)
    elif ffn == MOE:
        h = rms_norm(x, params["ffn_norm"], cfg.norm_eps)
        y, _ = F.moe_apply(params["ffn"], h, cfg=cfg, mode=mode,
                           placement=placement,
                           microbatches=decode_microbatches)
        x = x + y
    return x, new_cache


# ===========================================================================
# Model
# ===========================================================================
class Model:
    """Functional model: parameters and caches are passed in.
    ``decode_microbatches >= 2`` splits each decode MoE batch into that
    many §4.4 ping-pong micro-batches (1 = off)."""

    def __init__(self, cfg: ModelConfig, *, decode_microbatches: int = 1):
        kinds = cfg.layer_kinds()
        bad = sorted({k for k in kinds if k[0] not in (ATTN, MLA_ATTN)
                      or k[1] not in (MLP, MOE)})
        if bad or cfg.is_encdec or cfg.num_tail_layers:
            raise NotImplementedError(
                f"{cfg.name}: block kinds {bad}, an encoder or a tail after "
                f"the superblocks are not ported yet (global GQA and MLA "
                f"mixers with MLP/MoE FFNs only)")
        self.cfg = cfg
        self.decode_microbatches = decode_microbatches
        self.dtype = dtype_of(cfg.dtype)
        self.prefix_kinds = kinds[:len(cfg.prefix_layers)]
        self.pattern = cfg.layer_pattern
        self.n_sb = cfg.num_superblocks
        # the MTP head's block: the last pattern mixer with a dense MLP
        # (the reference puts global attention in place of a
        # cross-attention mixer, which the check above refuses)
        self.mtp_kind = (self.pattern[-1][0], MLP)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_spec(self) -> PyTree:
        cfg, dt = self.cfg, self.dtype
        spec: Dict[str, PyTree] = {
            "embed": ParamSpec((cfg.vocab_size, cfg.d_model), dt, "embed"),
            "final_norm": ParamSpec((cfg.d_model,), torch.float32, "zeros"),
        }
        if not cfg.tie_embeddings:
            spec["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size), dt,
                                        "embed")
        if self.prefix_kinds:
            spec["prefix"] = tuple(block_spec(cfg, k, dt)
                                   for k in self.prefix_kinds)
        if self.n_sb:
            spec["blocks"] = {
                f"pos{i}": tree_map(lambda s: s._replace(
                    shape=(self.n_sb,) + s.shape), block_spec(cfg, k, dt))
                for i, k in enumerate(self.pattern)}
        if cfg.mtp_num_layers:
            d = cfg.d_model
            norm = ParamSpec((d,), torch.float32, "zeros")
            spec["mtp"] = tuple(
                {"proj": ParamSpec((2 * d, d), dt, "dense", 2 * d),
                 "norm_h": norm, "norm_e": norm,
                 "block": block_spec(cfg, self.mtp_kind, dt)}
                for _ in range(cfg.mtp_num_layers))
        return spec

    def init(self, seed: int = 0, *, device="cuda") -> PyTree:
        """Random weights made on ``device`` from a seeded generator, with
        the reference's distributions (truncated-normal fan-in, 0.02
        embeddings, zero norm deviations)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def make(s: ParamSpec):
            if s.init == "zeros":
                return torch.zeros(s.shape, dtype=s.dtype, device=dev)
            if s.init == "embed":
                return embed_init(s.shape, s.dtype, gen, dev)
            return dense_init(s.shape, s.dtype, s.fan_in, gen, dev)
        return tree_map(make, self.param_spec())

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *,
                   device="cuda") -> PyTree:
        dev = resolve_device(device)

        def zeros(kind, lead=()):
            spec = (A.attn_cache_spec if kind[0] == ATTN
                    else A.mla_cache_spec)(self.cfg, batch, max_len)
            return {n: torch.zeros(lead + s, dtype=self.dtype, device=dev)
                    for n, s in spec.items()}
        cache: Dict[str, PyTree] = {}
        if self.prefix_kinds:
            cache["prefix"] = tuple(zeros(k) for k in self.prefix_kinds)
        if self.n_sb:
            cache["blocks"] = {f"pos{i}": zeros(k, (self.n_sb,))
                               for i, k in enumerate(self.pattern)}
        return cache

    def mtp_cache_spec(self, batch: int, max_len: int) -> PyTree:
        """Shapes of the MTP draft head's batched decode state (§4.6):
        ``"kv"``, the head block's decode cache (batch-major leaves, as
        the main cache's prefix layers), and ``"hidden"``, the ``[B, 1,
        d]`` main-model final hidden carried across decode iterations as
        the head's conditioning input."""
        spec = (A.attn_cache_spec if self.mtp_kind[0] == ATTN
                else A.mla_cache_spec)(self.cfg, batch, max_len)
        return {"kv": spec, "hidden": (batch, 1, self.cfg.d_model)}

    def init_mtp_cache(self, batch: int, max_len: int, *,
                       device="cuda") -> PyTree:
        dev = resolve_device(device)
        spec = self.mtp_cache_spec(batch, max_len)

        def zeros(shape):
            return torch.zeros(shape, dtype=self.dtype, device=dev)
        return {"kv": {n: zeros(s) for n, s in spec["kv"].items()},
                "hidden": zeros(spec["hidden"])}

    # ------------------------------------------------------------------
    # core stack application
    # ------------------------------------------------------------------
    def _apply_stack(self, params, x, *, mode, caches=None, positions=None,
                     placement=None):
        """``caches`` is updated in place in ``decode``/``chunk`` mode and
        returned; ``prefill`` returns freshly built caches."""
        cfg = self.cfg
        np_, pl_len = len(self.prefix_kinds), len(self.pattern)
        new_caches: Dict[str, PyTree] = {}

        def layer(p, x, kind, c, gl):
            lp = None if placement is None else placement.layer(gl)
            return block_apply(p, x, cfg=cfg, kind=kind, mode=mode, cache=c,
                               positions=positions, placement=lp,
                               decode_microbatches=self.decode_microbatches)

        prefix = []
        for i, kind in enumerate(self.prefix_kinds):
            c = None if caches is None else caches["prefix"][i]
            x, nc = layer(params["prefix"][i], x, kind, c, i)
            prefix.append(nc)
        if prefix:
            new_caches["prefix"] = tuple(prefix)
        if self.n_sb:
            per_sb = []
            for sb in range(self.n_sb):
                sb_params = _index(params["blocks"], sb)
                ncs = {}
                for i, kind in enumerate(self.pattern):
                    c = (None if caches is None
                         else _index(caches["blocks"][f"pos{i}"], sb))
                    x, ncs[f"pos{i}"] = layer(sb_params[f"pos{i}"], x, kind,
                                              c, np_ + sb * pl_len + i)
                per_sb.append(ncs)
            new_caches["blocks"] = (
                caches["blocks"] if caches is not None else
                {k: {n: torch.stack([c[k][n] for c in per_sb])
                     for n in per_sb[0][k]} for k in per_sb[0]})
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, (caches if caches is not None else new_caches)

    # ------------------------------------------------------------------
    # public steps
    # ------------------------------------------------------------------
    def _unembed(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _embed(self, params, tokens):
        return params["embed"][tokens].to(self.dtype)

    def _logits(self, params, h):
        return torch.matmul(h.float(), self._unembed(params).float())

    def prefill(self, params, tokens, last_pos=None):
        """tokens [B, S] → (logits at ``last_pos`` (default S-1) [B, V]
        f32, cache)."""
        x = self._embed(params, tokens)
        x, caches = self._apply_stack(params, x, mode="prefill")
        if last_pos is None:
            h = x[:, -1]
        else:
            h = x[torch.arange(x.shape[0], device=x.device), last_pos]
        return self._logits(params, h), caches

    def prefill_chunk(self, params, cache, tokens, offset: int, last_pos):
        """Run one contiguous chunk [B, S_chunk] of a prompt against the
        full-length cache buffers in ``cache`` (written in place at
        ``offset``). Returns (logits [B, V] at ``last_pos`` within the
        chunk, cache); on the final chunk these equal :meth:`prefill`'s."""
        x = self._embed(params, tokens)
        x, cache = self._apply_stack(params, x, mode="chunk", caches=cache,
                                     positions=int(offset))
        h = x[torch.arange(x.shape[0], device=x.device), last_pos]
        return self._logits(params, h), cache

    def decode_step(self, params, cache, tokens, positions, placement=None):
        """tokens [B, 1]; positions [B] → (logits [B, V] f32, cache); the
        cache is updated in place. ``placement``: an optional
        :class:`~repro_torch.serving.eplb.PlacementTable` on the device."""
        logits, _, cache = self.decode_step_hidden(params, cache, tokens,
                                                   positions, placement)
        return logits, cache

    def decode_step_hidden(self, params, cache, tokens, positions,
                           placement=None):
        """:meth:`decode_step` that also returns the final hidden state
        ``[B, 1, d]``, the MTP head's conditioning input. ``decode_step``
        delegates here, so the two give bit-identical logits."""
        x = self._embed(params, tokens)
        x, cache = self._apply_stack(params, x, mode="decode", caches=cache,
                                     positions=positions,
                                     placement=placement)
        return self._logits(params, x[:, -1]), x[:, -1:], cache

    # ------------------------------------------------------------------
    # MTP draft head (§4.6): h' = Block(proj([norm(h); norm(e_next)]))
    # ------------------------------------------------------------------
    def mtp_hidden(self, params, mtp_index: int, hidden, next_tokens,
                   positions, mtp_cache=None):
        """The head without its logits: hidden [B, 1, d] (the main
        model's final hidden), next_tokens [B, 1] → (new hidden [B, 1,
        d], cache). With ``mtp_cache`` the block runs in decode mode at
        ``positions`` [B] and writes the cache in place; without one it
        runs the prefill mode on the single token and keeps no cache
        (the reference's train mode). The draft-cache fill pass calls
        only this: eager PyTorch would run a discarded ``_logits``."""
        cfg = self.cfg
        mp = params["mtp"][mtp_index]
        e = self._embed(params, next_tokens)
        h = torch.cat([rms_norm(hidden, mp["norm_h"], cfg.norm_eps),
                       rms_norm(e, mp["norm_e"], cfg.norm_eps)], dim=-1)
        h = torch.matmul(h, mp["proj"])
        mode = "prefill" if mtp_cache is None else "decode"
        h, cache = block_apply(mp["block"], h, cfg=cfg, kind=self.mtp_kind,
                               mode=mode, cache=mtp_cache,
                               positions=positions)
        return h, (None if mtp_cache is None else cache)

    def mtp_step(self, params, mtp_index: int, hidden, next_tokens,
                 positions, mtp_cache=None):
        """:meth:`mtp_hidden` and the draft logits: → (logits [B, V] f32,
        new hidden [B, 1, d], cache)."""
        h, cache = self.mtp_hidden(params, mtp_index, hidden, next_tokens,
                                   positions, mtp_cache)
        return self._logits(params, h[:, -1]), h, cache
