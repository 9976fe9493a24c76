"""The transformer stack, with the reference's parameter and cache layout.

A model is a stack of blocks, each (sequence mixer, FFN) with pre-norms
and residual connections, split into:

  * ``prefix`` — explicit leading blocks (DeepSeek's dense layers), a
    tuple of per-layer dicts;
  * ``blocks`` — ``n_sb`` repetitions of ``cfg.layer_pattern``, each
    leaf stacked on a leading ``[n_sb, ...]`` axis (the reference scans
    over it; here a Python loop walks it);
  * ``tail``   — the pattern's remainder, a tuple of per-layer dicts
    (RecurrentGemma: 26 = 8·3 + 2).

Parameters are nested dicts of tensors whose paths and shapes equal the
JAX package's ``Model.init`` leaves, so ``models/weights.py`` can carry
weights across one to one. Mixers: global GQA (``ATTN``), ring-window
GQA (``LOCAL_ATTN``), cross-attention over a memory (``CROSS_ATTN``),
MLA, the RG-LRU recurrent block or the Mamba-2 SSD block, with MLP, MoE
or no FFN; the §4.6 MTP draft head (``mtp``: one (mixer, MLP) block
behind a projection of [norm(hidden); norm(embedding)]). A VLM is given
its ``memory`` (the stubbed vision frontend's patch embeddings); an
encoder-decoder model (``cfg.is_encdec``) runs its ``encoder`` stack —
non-causal, un-roped (ATTN, MLP) blocks at ``encoder_d_model`` and an
RMS norm — on the stubbed frontend's frames first. The cross-attention
layers keep the memory's K/V as their decode cache. ``long_context=True``
puts the configuration's ``long_context_window`` on global attention
(``window_override``), as the reference's long-context serving does.

Training (:meth:`Model.forward_train`) runs the ``train`` mode: the
prefill's computation with no cache built or written, the MoE layers on
the plain versions of their kernels, and the chunked cross-entropy;
``remat="full"`` recomputes each superblock in backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import (ATTN, CROSS_ATTN, LOCAL_ATTN, MLA_ATTN,
                                      MLP, MOE, RGLRU, SSM, ModelConfig)
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.common import (chunked_softmax_xent, dense_init,
                                       dtype_of, embed_init, naive_attention,
                                       resolve_device, rms_norm, tree_map)

PyTree = Any


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    #: "dense" | "embed" | "zeros", or a function (shape, generator,
    #: device) → float32 tensor (the recurrent blocks' fixed inits)
    init: Any
    fan_in: int = 0


def _index(tree, i):
    return tree_map(lambda t: t[i], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` superblocks of a stacked tree of dicts, each leaf's
    ``[i]`` a view. One ``unbind`` per leaf: under autograd a leaf's
    gradient is then one stack of the ``n`` parts, where ``n`` separate
    ``t[i]`` would each add a full-size zero tensor."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def attn_window(cfg: ModelConfig, mixer, window_override: int = 0) -> int:
    """The window of a GQA mixer (0 = global): the configuration's ring
    for ``LOCAL_ATTN``, ``window_override`` for ``ATTN``."""
    if mixer == LOCAL_ATTN:
        return cfg.sliding_window or cfg.rglru.window
    return window_override


# ===========================================================================
# Single block
# ===========================================================================
def _mixer_spec(cfg: ModelConfig, mixer, dtype) -> Dict[str, ParamSpec]:
    if mixer in (RGLRU, SSM):
        shapes = (R.rglru_param_shapes if mixer == RGLRU
                  else S.ssm_param_shapes)(cfg)
        return {n: ParamSpec(s, torch.float32 if f32 else dtype, init, fan)
                for n, (s, init, fan, f32) in shapes.items()}
    shapes = (A.mla_param_shapes(cfg) if mixer == MLA_ATTN
              else A.cross_attn_param_shapes(cfg) if mixer == CROSS_ATTN
              else A.attn_param_shapes(cfg))
    return {n: (ParamSpec(s, torch.float32, "zeros") if fan is None
                else ParamSpec(s, dtype, "dense", fan))
            for n, (s, fan) in shapes.items()}


def block_spec(cfg: ModelConfig, kind, dtype) -> Dict[str, PyTree]:
    mixer, ffn = kind
    d = cfg.d_model
    norm = ParamSpec((d,), torch.float32, "zeros")
    spec: Dict[str, PyTree] = {"mixer_norm": norm,
                               "mixer": _mixer_spec(cfg, mixer, dtype)}

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


def block_cache_spec(cfg: ModelConfig, kind, batch: int, max_len: int,
                     dtype, window_override: int = 0, mem_len: int = 0):
    """One block's decode cache: name → (shape, dtype). GQA keeps
    ``max_len`` slots (a ring of at most its window with one),
    cross-attention the memory's ``mem_len``, MLA its latents; the
    recurrent blocks a float32 state and a conv history."""
    mixer = kind[0]
    if mixer == CROSS_ATTN:
        return {n: (s, dtype) for n, s in
                A.cross_attn_cache_spec(cfg, batch, mem_len).items()}
    if mixer in (ATTN, LOCAL_ATTN):
        w = attn_window(cfg, mixer, window_override)
        return {n: (s, dtype) for n, s in
                A.attn_cache_spec(cfg, batch, max_len, w).items()}
    if mixer == MLA_ATTN:
        return {n: (s, dtype) for n, s in
                A.mla_cache_spec(cfg, batch, max_len).items()}
    return (R.rglru_cache_spec if mixer == RGLRU
            else S.ssm_cache_spec)(cfg, batch, dtype)


def block_apply(params, x, *, cfg: ModelConfig, kind, mode: str,
                cache=None, positions=None, memory=None, placement=None,
                decode_microbatches: int = 1, window_override: int = 0):
    """Returns (x_out, layer cache, the MoE layer's aux dict
    (``moe_lb_loss``, ``moe_z_loss``, ``expert_counts``) or None).
    ``memory``: what a cross-attention
    layer attends to in prefill (decode reads its cache);
    ``placement``: this layer's EPLB slice ``(replica_slots, n_replicas,
    phys_owner)`` or None;
    ``decode_microbatches``: the §4.4 ping-pong split of a decode MoE
    batch (1 = off; ``moe_apply`` applies it at decode only), as
    ``MeshCtx.decode_microbatches`` in the reference;
    ``window_override``: the window of global attention (0 = none)."""
    mixer, ffn = kind
    h = rms_norm(x, params["mixer_norm"], cfg.norm_eps)
    if mixer in (ATTN, LOCAL_ATTN):
        y, new_cache = A.attn_apply(
            params["mixer"], h, cfg=cfg, mode=mode,
            window=attn_window(cfg, mixer, window_override),
            cache=cache, positions=positions)
    elif mixer == CROSS_ATTN:
        y, new_cache = A.cross_attn_apply(params["mixer"], h, cfg=cfg,
                                          mode=mode, memory=memory,
                                          cache=cache)
    elif mixer == MLA_ATTN:
        y, new_cache = A.mla_apply(params["mixer"], h, cfg=cfg, mode=mode,
                                   cache=cache, positions=positions)
    else:
        apply = R.rglru_apply if mixer == RGLRU else S.ssm_apply
        y, new_cache = apply(params["mixer"], h, cfg=cfg, mode=mode,
                             cache=cache)
    x = x + y
    aux = None
    if ffn == MLP:
        h = rms_norm(x, params["ffn_norm"], cfg.norm_eps)
        x = x + F.mlp_apply(params["ffn"], h)
    elif ffn == MOE:
        h = rms_norm(x, params["ffn_norm"], cfg.norm_eps)
        y, aux = F.moe_apply(params["ffn"], h, cfg=cfg, mode=mode,
                             placement=placement,
                             microbatches=decode_microbatches)
        x = x + y
    return x, new_cache, aux


# ===========================================================================
# Model
# ===========================================================================
class Model:
    """Functional model: parameters and caches are passed in.
    ``decode_microbatches >= 2`` splits each decode MoE batch into that
    many §4.4 ping-pong micro-batches (1 = off). ``long_context=True``
    gives global attention the configuration's ``long_context_window``
    (``window_override``) where the architecture does not already avoid
    a cache that grows with the sequence, as in the reference.
    ``remat="full"`` recomputes each superblock's activations in the
    backward pass of training (the reference's ``MeshCtx.remat``)."""

    def __init__(self, cfg: ModelConfig, *, decode_microbatches: int = 1,
                 long_context: bool = False, remat: str = "none"):
        if remat not in ("none", "full"):
            raise ValueError(f"remat must be 'none' or 'full', got {remat!r}")
        kinds = cfg.layer_kinds()
        self.cfg = cfg
        self.remat = remat
        self.decode_microbatches = decode_microbatches
        self.dtype = dtype_of(cfg.dtype)
        self.window_override = (cfg.long_context_window
                                if long_context
                                and not cfg.supports_long_context else 0)
        np_ = len(cfg.prefix_layers)
        self.prefix_kinds = kinds[:np_]
        self.pattern = cfg.layer_pattern
        self.n_sb = cfg.num_superblocks
        self.tail_kinds = kinds[np_ + self.n_sb * len(self.pattern):]
        #: a cross-attention layer reads a memory: prefill needs one
        self.has_cross = any(m == CROSS_ATTN for m, _ in kinds)
        # the MTP head's block: the last pattern mixer with a dense MLP,
        # global attention in place of cross-attention (the reference's
        # rule: the head has no memory)
        mixer = self.pattern[-1][0]
        self.mtp_kind = (ATTN if mixer == CROSS_ATTN else mixer, MLP)

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
        if self.tail_kinds:
            spec["tail"] = tuple(block_spec(cfg, k, dt)
                                 for k in self.tail_kinds)
        if cfg.is_encdec:
            ecfg = self._encoder_cfg()
            spec["encoder"] = {
                "blocks": tuple(block_spec(ecfg, (ATTN, MLP), dt)
                                for _ in range(cfg.encoder_layers)),
                "norm": ParamSpec((ecfg.d_model,), torch.float32, "zeros")}
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
            if callable(s.init):
                return s.init(s.shape, gen, dev).to(s.dtype)
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
                   mem_len: Optional[int] = None, device="cuda") -> PyTree:
        """Zeros in each block's cache layout (:func:`block_cache_spec`):
        ``prefix`` and ``tail`` per layer, ``blocks`` stacked; a
        cross-attention layer keeps ``mem_len`` slots (default
        ``cfg.num_frontend_tokens``)."""
        dev = resolve_device(device)
        mem_len = mem_len or self.cfg.num_frontend_tokens

        def zeros(kind, lead=()):
            spec = block_cache_spec(self.cfg, kind, batch, max_len,
                                    self.dtype, self.window_override,
                                    mem_len)
            return {n: torch.zeros(lead + s, dtype=dt, device=dev)
                    for n, (s, dt) in spec.items()}
        cache: Dict[str, PyTree] = {}
        if self.prefix_kinds:
            cache["prefix"] = tuple(zeros(k) for k in self.prefix_kinds)
        if self.n_sb:
            cache["blocks"] = {f"pos{i}": zeros(k, (self.n_sb,))
                               for i, k in enumerate(self.pattern)}
        if self.tail_kinds:
            cache["tail"] = tuple(zeros(k) for k in self.tail_kinds)
        return cache

    def _mtp_kv_spec(self, batch: int, max_len: int):
        # no window_override, as the reference's MTP block
        return block_cache_spec(self.cfg, self.mtp_kind, batch, max_len,
                                self.dtype)

    def mtp_cache_spec(self, batch: int, max_len: int) -> PyTree:
        """Shapes of the MTP draft head's batched decode state (§4.6):
        ``"kv"``, the head block's decode cache (batch-major leaves, as
        the main cache's prefix layers), and ``"hidden"``, the ``[B, 1,
        d]`` main-model final hidden carried across decode iterations as
        the head's conditioning input."""
        return {"kv": {n: s for n, (s, _) in
                       self._mtp_kv_spec(batch, max_len).items()},
                "hidden": (batch, 1, self.cfg.d_model)}

    def init_mtp_cache(self, batch: int, max_len: int, *,
                       device="cuda") -> PyTree:
        dev = resolve_device(device)
        return {"kv": {n: torch.zeros(s, dtype=dt, device=dev) for n, (s, dt)
                       in self._mtp_kv_spec(batch, max_len).items()},
                "hidden": torch.zeros((batch, 1, self.cfg.d_model),
                                      dtype=self.dtype, device=dev)}

    # ------------------------------------------------------------------
    # core stack application
    # ------------------------------------------------------------------
    def _apply_stack(self, params, x, *, mode, caches=None, positions=None,
                     memory=None, placement=None):
        """→ (x, caches, aux). ``caches`` is updated in place in
        ``decode``/``chunk`` mode and returned; ``prefill`` returns
        freshly built caches, ``train`` none. ``aux`` is None except in
        ``train`` mode: (load-balance loss, z-loss, expert counts), the
        MoE layers' coefficient-scaled losses added in layer order and
        their counts summed ([E] float32; [1] zeros without MoE), as the
        reference's ``aux_sum`` and ``counts``."""
        cfg = self.cfg
        train = mode == "train"
        np_, pl_len = len(self.prefix_kinds), len(self.pattern)
        new_caches: Dict[str, PyTree] = {}
        aux = (None,) * 3
        if train:
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            aux = (zero, zero,
                   torch.zeros((cfg.moe.num_experts if cfg.has_moe else 1,),
                               dtype=torch.float32, device=x.device))

        def layer(p, x, kind, c, gl, aux):
            lp = None if placement is None else placement.layer(gl)
            x, nc, moe = block_apply(
                p, x, cfg=cfg, kind=kind, mode=mode, cache=c,
                positions=positions, memory=memory, placement=lp,
                decode_microbatches=self.decode_microbatches,
                window_override=self.window_override)
            if train and moe is not None:
                aux = (aux[0] + moe["moe_lb_loss"], aux[1] + moe["moe_z_loss"],
                       aux[2] + moe["expert_counts"])
            return x, nc, aux

        def unrolled(section, kinds, first, x, aux):
            out = []
            for i, kind in enumerate(kinds):
                c = None if caches is None else caches[section][i]
                x, nc, aux = layer(params[section][i], x, kind, c, first + i,
                                   aux)
                out.append(nc)
            if out and not train:
                new_caches[section] = tuple(out)
            return x, aux

        def superblock(sb, sb_params, x, *aux):
            ncs = {}
            for i, kind in enumerate(self.pattern):
                c = (None if caches is None
                     else _index(caches["blocks"][f"pos{i}"], sb))
                x, ncs[f"pos{i}"], aux = layer(sb_params[f"pos{i}"], x, kind,
                                               c, np_ + sb * pl_len + i, aux)
            return (x, *aux), ncs

        x, aux = unrolled("prefix", self.prefix_kinds, 0, x, aux)
        if self.n_sb:
            per_sb = []
            for sb, sb_params in enumerate(_unstack(params["blocks"],
                                                    self.n_sb)):
                if train and self.remat == "full":
                    x, *aux = torch.utils.checkpoint.checkpoint(
                        lambda *a, sb=sb: superblock(sb, *a)[0], sb_params,
                        x, *aux, use_reentrant=False)
                else:
                    (x, *aux), ncs = superblock(sb, sb_params, x, *aux)
                    per_sb.append(ncs)
            if not train:
                new_caches["blocks"] = (
                    caches["blocks"] if caches is not None else
                    {k: {n: torch.stack([c[k][n] for c in per_sb])
                         for n in per_sb[0][k]} for k in per_sb[0]})
        x, aux = unrolled("tail", self.tail_kinds,
                          np_ + self.n_sb * pl_len, x, tuple(aux))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        if train:
            return x, None, tuple(aux)
        return x, (caches if caches is not None else new_caches), None

    # ------------------------------------------------------------------
    # encoder (the encoder-decoder's stubbed audio frontend's frames)
    # ------------------------------------------------------------------
    def _encoder_cfg(self) -> ModelConfig:
        """The encoder's blocks: (ATTN, MLP) at ``encoder_d_model``."""
        cfg = self.cfg
        return dataclasses.replace(
            cfg, d_model=cfg.encoder_d_model or cfg.d_model,
            prefix_layers=(), layer_pattern=((ATTN, MLP),),
            num_layers=cfg.encoder_layers)

    def encode(self, params, frames):
        """frames [B, M, encoder_d_model] → memory [B, M,
        encoder_d_model]: per block, non-causal un-roped self-attention
        and the MLP, each behind a pre-norm, then an RMS norm."""
        eps = self.cfg.norm_eps
        x = frames.to(self.dtype)
        for bp in params["encoder"]["blocks"]:
            h = rms_norm(x, bp["mixer_norm"], eps)
            q, k, v = (torch.einsum("bsd,dhk->bshk", h, bp["mixer"][n])
                       for n in ("wq", "wk", "wv"))
            o = naive_attention(q, k, v, causal=False)
            x = x + torch.einsum("bshk,hkd->bsd", o, bp["mixer"]["wo"])
            h = rms_norm(x, bp["ffn_norm"], eps)
            x = x + F.mlp_apply(bp["ffn"], h)
        return rms_norm(x, params["encoder"]["norm"], eps)

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

    def _memory(self, params, memory):
        """What the cross-attention layers read, in the model's dtype:
        ``memory`` itself, or for an encoder-decoder the encoder's
        output on it (its frames)."""
        if memory is None:
            raise ValueError(f"{self.cfg.name}: needs memory (its "
                             f"cross-attention layers read it)")
        memory = memory.to(self.dtype)
        return self.encode(params, memory) if self.cfg.is_encdec else memory

    def forward_train(self, params, tokens, labels, memory=None,
                      loss_mask=None):
        """tokens, labels [B, S] → (loss, metrics), differentiable in
        ``params``: ``loss = nll + lb + z``, the chunked cross-entropy's
        mean over the tokens ``loss_mask`` [B, S] counts (default all)
        plus the MoE layers' aux losses. ``metrics``: ``nll``,
        ``moe_lb_loss``, ``moe_z_loss``, ``tokens`` (the counted
        tokens) and ``expert_counts`` (summed over the MoE layers). No
        cache is built and no kernel launched: the MoE layers run the
        plain versions. A model with cross-attention needs ``memory``,
        as :meth:`prefill`."""
        if self.has_cross:
            memory = self._memory(params, memory)
        x = self._embed(params, tokens)
        x, _, (lb, z, counts) = self._apply_stack(params, x, mode="train",
                                                  memory=memory)
        nll, n_tok = chunked_softmax_xent(x, labels, self._unembed(params),
                                          mask=loss_mask)
        loss = nll + lb + z
        return loss, {"nll": nll, "moe_lb_loss": lb, "moe_z_loss": z,
                      "tokens": n_tok, "expert_counts": counts}

    def prefill(self, params, tokens, *, memory=None, last_pos=None):
        """tokens [B, S] → (logits at ``last_pos`` (default S-1) [B, V]
        f32, cache). A model with cross-attention needs ``memory`` [B,
        M, md]: the frames its encoder runs on (``cfg.is_encdec``), else
        the memory itself; it is taken in the model's dtype."""
        if self.has_cross:
            memory = self._memory(params, memory)
        x = self._embed(params, tokens)
        x, caches, _ = self._apply_stack(params, x, mode="prefill",
                                         memory=memory)
        if last_pos is None:
            h = x[:, -1]
        else:
            h = x[torch.arange(x.shape[0], device=x.device), last_pos]
        return self._logits(params, h), caches

    def prefill_chunk(self, params, cache, tokens, offset: int, last_pos):
        """Run one contiguous chunk [B, S_chunk] of a prompt against the
        full-length cache buffers in ``cache`` (written in place at
        ``offset``). Returns (logits [B, V] at ``last_pos`` within the
        chunk, cache); on the final chunk these equal :meth:`prefill`'s.
        Decoder-only models without cross-attention."""
        if self.has_cross:
            raise ValueError(f"{self.cfg.name}: chunked prefill runs no "
                             f"cross-attention or encoder")
        x = self._embed(params, tokens)
        x, cache, _ = self._apply_stack(params, x, mode="chunk",
                                        caches=cache, positions=int(offset))
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
        x, cache, _ = self._apply_stack(params, x, mode="decode",
                                        caches=cache, positions=positions,
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
        runs the train mode over the sequence it is given and keeps no
        cache, as the reference. The draft-cache fill pass calls
        only this: eager PyTorch would run a discarded ``_logits``."""
        cfg = self.cfg
        mp = params["mtp"][mtp_index]
        e = self._embed(params, next_tokens)
        h = torch.cat([rms_norm(hidden, mp["norm_h"], cfg.norm_eps),
                       rms_norm(e, mp["norm_e"], cfg.norm_eps)], dim=-1)
        h = torch.matmul(h, mp["proj"])
        mode = "train" if mtp_cache is None else "decode"
        h, cache, _ = block_apply(mp["block"], h, cfg=cfg, kind=self.mtp_kind,
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


def seeded_memory(cfg: ModelConfig, generator: torch.Generator, device,
                  dtype=torch.float32) -> torch.Tensor:
    """[1, num_frontend_tokens, md] standard normal from ``generator``:
    what the stubbed frontends give a model with cross-attention (a
    VLM's patch embeddings, an encoder-decoder's frames)."""
    md = cfg.encoder_d_model or cfg.d_model
    return torch.randn((1, cfg.num_frontend_tokens, md), generator=generator,
                       device=device, dtype=dtype)
