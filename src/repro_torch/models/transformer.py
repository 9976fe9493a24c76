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
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``, its
collectives issued again. On a mesh it runs prefill's mesh path under
autograd (the collectives' backward rule: ``models/mesh_ctx.py``), with
a vocab-parallel cross-entropy and the loss's mean taken over every data
rank's tokens; :meth:`Model.reduce_grads` finishes each leaf's gradient.
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
from repro_torch.launch import sharding as shd
from repro_torch.models.mesh_ctx import make_smoke_ctx
from repro_torch.models.common import (chunked_softmax_xent, dense_init,
                                       dtype_of, embed_init, naive_attention,
                                       part_seed, resolve_device, rms_norm,
                                       tree_map, xent_sum)

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


def _tp_hidden(ctx, specs, name: str):
    """The TP axis when this rank holds its block of the hidden dim of
    the SwiGLU ``specs[name]`` (a dense MLP or a shared expert)."""
    if specs is None or name not in specs or ctx.tp_size <= 1:
        return None
    return ctx.tp_axis if specs[name]["wo"].entry(0) == ctx.tp_axis \
        else None


def block_apply(params, x, *, cfg: ModelConfig, kind, mode: str,
                cache=None, positions=None, memory=None, placement=None,
                decode_microbatches: int = 1, window_override: int = 0,
                ctx=None, specs=None, sp_axis=None, mem_axis=None):
    """Returns (x_out, layer cache, the MoE layer's aux dict
    (``moe_lb_loss``, ``moe_z_loss``, ``expert_counts``) or None).
    ``memory``: what a cross-attention
    layer attends to in prefill (decode reads its cache);
    ``placement``: this layer's EPLB slice ``(replica_slots, n_replicas,
    phys_owner)`` or None;
    ``decode_microbatches``: the §4.4 ping-pong split of a decode MoE
    batch (1 = off; ``moe_apply`` applies it at decode only), as
    ``MeshCtx.decode_microbatches`` in the reference;
    ``window_override``: the window of global attention (0 = none).
    ``ctx``: the mesh context, and ``specs`` the layer's parameter specs
    as this rank holds them (None on one device); ``sp_axis``: ``x`` is
    this rank's block of the sequence over that axis (the
    sequence-parallel residual): each sublayer reads the gathered
    sequence and adds back its own block; ``mem_axis``: the axis the
    decode cache of a cross-attention layer cuts the memory's slots over
    (None: uncut)."""
    mixer, ffn = kind

    def full(h):
        return h if sp_axis is None else ctx.all_gather(h, sp_axis, dim=1)

    def mine(y):
        return y if sp_axis is None else ctx.take_block(y, 1, sp_axis)
    mesh = {} if specs is None else dict(ctx=ctx, specs=specs["mixer"])
    h = full(rms_norm(x, params["mixer_norm"], cfg.norm_eps))
    if mixer in (ATTN, LOCAL_ATTN):
        y, new_cache = A.attn_apply(
            params["mixer"], h, cfg=cfg, mode=mode,
            window=attn_window(cfg, mixer, window_override),
            cache=cache, positions=positions, **mesh)
    elif mixer == CROSS_ATTN:
        y, new_cache = A.cross_attn_apply(params["mixer"], h, cfg=cfg,
                                          mode=mode, memory=memory,
                                          cache=cache, mem_axis=mem_axis,
                                          **mesh)
    elif mixer == MLA_ATTN:
        y, new_cache = A.mla_apply(params["mixer"], h, cfg=cfg, mode=mode,
                                   cache=cache, positions=positions, **mesh)
    elif mixer == RGLRU:
        y, new_cache = R.rglru_apply(params["mixer"], h, cfg=cfg, mode=mode,
                                     cache=cache, **mesh)
    else:
        y, new_cache = S.ssm_apply(params["mixer"], h, cfg=cfg, mode=mode,
                                   cache=cache)
    x = x + mine(y)
    aux = None
    if ffn == MLP:
        h = full(rms_norm(x, params["ffn_norm"], cfg.norm_eps))
        x = x + mine(F.mlp_apply(params["ffn"], h, ctx=ctx,
                                 tp_axis=_tp_hidden(ctx, specs, "ffn")))
    elif ffn == MOE:
        h = full(rms_norm(x, params["ffn_norm"], cfg.norm_eps))
        y, aux = F.moe_apply(
            params["ffn"], h, cfg=cfg, mode=mode, placement=placement,
            microbatches=decode_microbatches, ctx=ctx,
            tp_axis=_tp_hidden(ctx, None if specs is None
                               else specs["ffn"], "shared"))
        x = x + mine(y)
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
    backward pass of training (the reference's ``MeshCtx.remat``).

    ``ctx`` (default: the 1×1 smoke context, the one-device path) is the
    mesh: on more than one rank (one process each, SPMD) every rank holds
    its block of each parameter under the rules ``rules`` resolve
    (``launch/sharding.py``; default ``LOGICAL_RULES``, ``DECODE_RULES``
    for the decode profile), gathers at use the dims its computation does
    not shard (the FSDP ``embed`` dim), and runs heads tensor-parallel,
    experts over the EP axes and the decode cache over the sequence axis.
    Inputs and outputs stay global: each rank takes its batch block where
    the batch divides the batch axes (replicated otherwise, as
    ``batch_pspec``), and the logits are all-gathered, so every rank
    samples the same token. Caches: a prefill or chunk buffer is the
    batch block with every slot; the decode cache
    (``init_cache(local=True)`` or :meth:`place_cache`) also only this
    rank's slots. Every mixer runs there, with MLP and MoE, as do the
    encoder and the MTP head (its decode cache
    ``init_mtp_cache(local=True)``): RG-LRU with its channels over the
    TP axis, the SSD replicated over it (rows only), cross-attention
    with its heads over TP and the memory's K/V over the sequence axis
    where ``cache_pspecs`` cuts them (``mem_axis``). Training runs there
    too (:meth:`forward_train`, :meth:`train_axes`,
    :meth:`reduce_grads`)."""

    def __init__(self, cfg: ModelConfig, *, ctx=None, rules=None,
                 decode_microbatches: Optional[int] = None,
                 long_context: bool = False, remat: str = "none"):
        if remat not in ("none", "full"):
            raise ValueError(f"remat must be 'none' or 'full', got {remat!r}")
        kinds = cfg.layer_kinds()
        self.cfg = cfg
        self.remat = remat
        self.ctx = make_smoke_ctx() if ctx is None else ctx
        self.sharded = self.ctx.sharded
        self.decode_microbatches = (self.ctx.decode_microbatches
                                    if decode_microbatches is None
                                    else decode_microbatches)
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
        #: the memory's slots in the cross-attention layers' decode cache
        #: (``init_cache(mem_len=)``, ``place_cache``): what decides
        #: whether the decode layout cuts them (:attr:`mem_axis`)
        self.mem_len = cfg.num_frontend_tokens
        #: each parameter's spec under ``rules`` on ``ctx.mesh``
        self.specs = shd.param_pspecs(self.param_spec(), self.ctx.mesh,
                                      rules)
        self._sb_specs = (tree_map(lambda sp: shd.PSpec(*sp[1:]),
                                   self.specs["blocks"])
                          if self.n_sb else None)

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
        """Random weights from ``seed`` with the reference's
        distributions (truncated-normal fan-in, 0.02 embeddings, zero
        norm deviations), the same on every device: leaf ``i``
        (:meth:`init_leaf`) is a function of ``(seed, i)``, drawn where it
        lives, one leaf at a time. On a mesh each rank keeps only its
        block of each leaf: drawn alone where one dim is cut, else made
        whole in host memory and cut there. ``device="meta"``: the
        leaves' shapes and dtypes only (this rank's blocks), nothing
        drawn — the dry run's ``jax.eval_shape(model.init)``."""
        if torch.device(device).type == "meta":
            return shd.spec_tree_map(
                lambda s, sp: torch.empty(shd.local_shape(s.shape, sp,
                                                          self.ctx),
                                          dtype=s.dtype, device="meta"),
                self.param_spec(), self.specs)
        dev = resolve_device(device)
        count = iter(range(1 << 30))
        return shd.spec_tree_map(
            lambda s, spec: self.init_leaf(seed, next(count), s, spec, dev),
            self.param_spec(), self.specs)

    def init_leaf(self, seed: int, i: int, s: ParamSpec, spec,
                  device) -> torch.Tensor:
        """Leaf ``i`` (in :meth:`param_spec` order) of :meth:`init`, this
        rank's block of it under ``spec``, on ``device``."""
        ctx = self.ctx
        dims = [k for k in range(len(s.shape)) if spec.entry(k) is not None
                and ctx.axis_size(spec.entry(k)) > 1]
        if s.init in ("dense", "embed") and len(dims) == 1:
            # one dim cut, the ones after it whole: draw the block alone
            k = dims[0]
            size = s.shape[k] // ctx.axis_size(spec.entry(k))
            lo = ctx.axis_index(spec.entry(k)) * size
            blk = (tuple(s.shape), k, lo, lo + size)
            if s.init == "embed":
                return embed_init(s.shape, s.dtype, part_seed(seed, i),
                                  device, block=blk)
            return dense_init(s.shape, s.dtype, s.fan_in,
                              part_seed(seed, i), device, block=blk)
        where = device if not dims else "cpu"
        if callable(s.init):
            gen = torch.Generator().manual_seed(part_seed(seed, i))
            t = s.init(s.shape, gen, "cpu").to(s.dtype)
        elif s.init == "zeros":
            t = torch.zeros(s.shape, dtype=s.dtype, device=where)
        elif s.init == "embed":
            t = embed_init(s.shape, s.dtype, part_seed(seed, i), where)
        else:
            t = dense_init(s.shape, s.dtype, s.fan_in, part_seed(seed, i),
                           where)
        if dims:
            t = shd.take_local(t, spec, ctx)
        return t.to(device)

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def cache_spec(self, batch: int, max_len: int, *,
                   mem_len: Optional[int] = None) -> PyTree:
        """The global cache's leaves as ``meta`` tensors (shape and dtype
        stand-ins), in :meth:`init_cache`'s layout."""
        return self.init_cache(batch, max_len, mem_len=mem_len,
                               device="meta")

    def init_cache(self, batch: int, max_len: int, *,
                   mem_len: Optional[int] = None, device="cuda",
                   local: bool = False) -> PyTree:
        """Zeros in each block's cache layout (:func:`block_cache_spec`):
        ``prefix`` and ``tail`` per layer, ``blocks`` stacked; a
        cross-attention layer keeps ``mem_len`` slots (default
        ``cfg.num_frontend_tokens``). On a mesh: this rank's batch block
        where the batch divides the batch axes, every slot; with
        ``local=True`` the decode layout (``cache_pspecs``), only this
        rank's block of slots too."""
        dev = device if device == "meta" else resolve_device(device)
        mem_len = mem_len or self.cfg.num_frontend_tokens
        if local and dev != "meta":
            self.mem_len = mem_len

        def zeros(kind, lead=()):
            spec = block_cache_spec(self.cfg, kind, batch, max_len,
                                    self.dtype, self.window_override,
                                    mem_len)
            return {n: torch.zeros(lead + s, dtype=dt, device=dev)
                    for n, (s, dt) in spec.items()}
        if self.sharded and dev != "meta":
            full = self.cache_spec(batch, max_len, mem_len=mem_len)
            return shd.spec_tree_map(
                lambda t, sp: torch.zeros(shd.local_shape(t.shape, sp,
                                                          self.ctx),
                                          dtype=t.dtype, device=dev),
                full, self._layout_specs(full, local))
        cache: Dict[str, PyTree] = {}
        if self.prefix_kinds:
            cache["prefix"] = tuple(zeros(k) for k in self.prefix_kinds)
        if self.n_sb:
            cache["blocks"] = {f"pos{i}": zeros(k, (self.n_sb,))
                               for i, k in enumerate(self.pattern)}
        if self.tail_kinds:
            cache["tail"] = tuple(zeros(k) for k in self.tail_kinds)
        return cache

    def _layout_specs(self, full: PyTree, local: bool) -> PyTree:
        """Specs of a global cache ``full`` (leaves with ``.shape``): the
        decode layout (``local``: ``cache_pspecs``) or the prefill layout
        (the batch only). The decode layout must cut the slots wherever
        the sequence axis has ranks and ``shard_kv_seq`` is on, as the
        reference's decode ``shard_map`` requires; a cross-attention
        layer's memory stays whole where its length does not divide the
        axis, as in the reference."""
        ctx = self.ctx
        seq_on = ctx.shard_kv_seq and ctx.axis_size(ctx.seq_axis) > 1

        def pick(keys, sp):
            if keys[-1] not in ("k", "v", "ckv", "krope"):
                return sp
            dim = 2 if "blocks" in keys else 1
            if not local:
                return shd.PSpec(*(None if i == dim else e
                                   for i, e in enumerate(sp)))
            if (seq_on and sp.entry(dim) is None
                    and self._kind_at(keys)[0] != CROSS_ATTN):
                raise ValueError(f"decode cache {keys}: its slots do not "
                                 f"divide the {ctx.seq_axis!r} axis")
            return sp
        return shd.map_with_paths(shd.cache_pspecs(full, ctx), pick)

    def place_cache(self, cache: PyTree, batch: int) -> PyTree:
        """A cache in the prefill layout (this rank's batch block of a
        global batch of ``batch`` rows, every slot) → the decode layout:
        this rank's block of slots, copied out."""
        if not self.sharded:
            return cache

        def glob(keys, t):
            shape = list(t.shape)
            shape[1 if "blocks" in keys else 0] = batch
            return torch.empty(shape, dtype=t.dtype, device="meta")
        full = shd.map_with_paths(cache, glob)
        cross = [t.shape[2 if "blocks" in k else 1] for k, t in
                 shd.leaves_by_path(full).items()
                 if k[-1] == "k" and self._kind_at(k)[0] == CROSS_ATTN]
        if cross:
            self.mem_len = cross[0]
        flat = shd.leaves_by_path(self._layout_specs(full, True))

        def cut(keys, t):
            if keys[-1] not in ("k", "v", "ckv", "krope"):
                return t
            dim = 2 if "blocks" in keys else 1
            e = flat[keys].entry(dim)
            return t if e is None else self.ctx.take_block(t, dim, e).clone()
        return shd.map_with_paths(cache, cut)

    def _kind_at(self, keys: tuple):
        """The layer kind a cache leaf's path ``keys`` belongs to (an MTP
        cache's ``("kv", name)``: the head's block)."""
        if keys[0] == "blocks":
            return self.pattern[int(keys[1][3:])]
        if keys[0] in ("prefix", "tail"):
            return (self.prefix_kinds if keys[0] == "prefix"
                    else self.tail_kinds)[keys[1]]
        return self.mtp_kind

    @property
    def mem_axis(self):
        """The axis the decode cache cuts the memory's slots over (the
        cross-attention K/V), or None: every rank holds every slot."""
        ctx = self.ctx
        n = ctx.axis_size(ctx.seq_axis)
        if (not self.has_cross or not ctx.shard_kv_seq or n == 1
                or self.mem_len % n):
            return None
        return ctx.seq_axis

    def slot_axis(self, keys: tuple):
        """The axis the decode cache cuts the slots of leaf ``keys`` over
        (K/V, latents), or None: every rank holds every slot."""
        ctx = self.ctx
        if (keys[-1] not in ("k", "v", "ckv", "krope")
                or not ctx.shard_kv_seq or ctx.axis_size(ctx.seq_axis) == 1):
            return None
        if self._kind_at(keys)[0] == CROSS_ATTN:
            return self.mem_axis
        return ctx.seq_axis

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

    def init_mtp_cache(self, batch: int, max_len: int, *, device="cuda",
                       local: bool = False) -> PyTree:
        """Zeros in :meth:`mtp_cache_spec`'s layout. On a mesh, as
        :meth:`init_cache`: this rank's batch block where the batch
        divides the batch axes; with ``local=True`` the decode layout,
        only this rank's block of the head's slots too."""
        dev = resolve_device(device)
        full = {"kv": {n: torch.empty(s, dtype=dt, device="meta")
                       for n, (s, dt)
                       in self._mtp_kv_spec(batch, max_len).items()},
                "hidden": torch.empty((batch, 1, self.cfg.d_model),
                                      dtype=self.dtype, device="meta")}
        if not self.sharded:
            return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                                  device=dev), full)
        return shd.spec_tree_map(
            lambda t, sp: torch.zeros(shd.local_shape(t.shape, sp,
                                                      self.ctx),
                                      dtype=t.dtype, device=dev),
            full, self._layout_specs(full, local))

    # ------------------------------------------------------------------
    # core stack application
    # ------------------------------------------------------------------
    def _view(self, p, spec):
        """A layer's parameters as it computes with them, and their specs:
        on a mesh every sharded dim is all-gathered except the heads,
        hidden and RG-LRU channel dims on the TP axis and the expert dim
        on the EP axes (None, None on one device)."""
        if not self.sharded:
            return p, None
        ctx = self.ctx
        ep = ctx.ep_axis
        if not isinstance(ep, str):
            ep = tuple(ep) if len(ep) > 1 else ep[0]

        def walk(p, sp, keys):
            if isinstance(p, dict):
                parts = {k: walk(p[k], sp[k], keys + (k,)) for k in p}
                return ({k: v[0] for k, v in parts.items()},
                        {k: v[1] for k, v in parts.items()})
            if isinstance(p, tuple):
                parts = [walk(a, b, keys + (i,))
                         for i, (a, b) in enumerate(zip(p, sp))]
                return tuple(a for a, _ in parts), tuple(b for _, b in parts)
            rule = shd.PARAM_RULES.get((keys[-1], p.dim())) or ()
            kept = []
            for dim in range(p.dim()):
                e = sp.entry(dim)
                lg = rule[dim] if dim < len(rule) else None
                if e is None or (lg in ("heads", "kv_heads", "mlp", "lru")
                                 and e == ctx.tp_axis) or (
                                     lg == "expert" and e == ep):
                    kept.append(e)
                else:
                    p = ctx.all_gather(p, e, dim=dim)
                    kept.append(None)
            return p, shd.PSpec(*kept)
        return walk(p, spec, ())

    def _batch_ctx(self, batch: int):
        """(ctx, sharded): the context a global batch of ``batch`` rows
        runs under — batch axes only where they divide it (the rows are
        replicated otherwise, as ``batch_pspec``)."""
        ctx = self.ctx
        if not self.sharded or (ctx.dp_size > 1 and batch % ctx.dp_size == 0):
            return ctx, ctx.dp_size > 1
        return dataclasses.replace(ctx, batch_axes=()), False

    def _rows(self, ctx, sharded: bool, *ts):
        """This rank's batch block of each tensor (or the tensor)."""
        if not sharded:
            return ts
        return tuple(ctx.take_block(t, 0, ctx.batch_axes) for t in ts)

    def _residual_constraint(self, x, mode: str, ctx):
        """The sequence-parallel residual in prefill: ``x`` cut to this
        rank's block of the sequence over the TP axis where it divides;
        → (x, axis or None)."""
        if (self.sharded and mode in ("train", "prefill", "chunk")
                and ctx.tp_size > 1 and x.shape[1] % ctx.tp_size == 0):
            return ctx.take_block(x, 1, ctx.tp_axis), ctx.tp_axis
        return x, None

    def _apply_stack(self, params, x, *, mode, caches=None, positions=None,
                     memory=None, placement=None, ctx=None, sp_axis=None):
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

        ctx = self.ctx if ctx is None else ctx

        def layer(p, x, kind, c, gl, aux, spec):
            lp = None if placement is None else placement.layer(gl)
            p, lspec = self._view(p, spec)
            x, nc, moe = block_apply(
                p, x, cfg=cfg, kind=kind, mode=mode, cache=c,
                positions=positions, memory=memory, placement=lp,
                decode_microbatches=self.decode_microbatches,
                window_override=self.window_override, ctx=ctx, specs=lspec,
                sp_axis=sp_axis, mem_axis=self.mem_axis)
            if train and moe is not None:
                aux = (aux[0] + moe["moe_lb_loss"], aux[1] + moe["moe_z_loss"],
                       aux[2] + moe["expert_counts"])
            return x, nc, aux

        def unrolled(section, kinds, first, x, aux):
            out = []
            for i, kind in enumerate(kinds):
                c = None if caches is None else caches[section][i]
                x, nc, aux = layer(params[section][i], x, kind, c, first + i,
                                   aux, self.specs[section][i])
                out.append(nc)
            if out and not train:
                new_caches[section] = tuple(out)
            return x, aux

        def superblock(sb, sb_params, x, *aux):
            ncs = {}
            for i, kind in enumerate(self.pattern):
                c = (None if caches is None
                     else _index(caches["blocks"][f"pos{i}"], sb))
                x, ncs[f"pos{i}"], aux = layer(
                    sb_params[f"pos{i}"], x, kind, c, np_ + sb * pl_len + i,
                    aux, None if self._sb_specs is None
                    else self._sb_specs[f"pos{i}"])
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
        if sp_axis is not None:
            x = ctx.all_gather(x, sp_axis, dim=1)
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

    def encode(self, params, frames, ctx=None):
        """frames [B, M, encoder_d_model] → memory [B, M,
        encoder_d_model]: per block, non-causal un-roped self-attention
        and the MLP, each behind a pre-norm, then an RMS norm.

        On a mesh ``frames`` are this rank's rows (``ctx``: the batch's
        context) and the memory comes back as them, whole along the
        sequence. Each block's heads and MLP hidden dim go over the TP
        axis where they divide it: this rank's block of each weight
        (which the rules leave whole: the reference's table reads the
        encoder's per-block leaves as a stacked layer's), the partial
        products summed in float32; the residual is sequence-parallel
        where the frames divide the axis."""
        eps = self.cfg.norm_eps
        ctx = self.ctx if ctx is None else ctx
        ecfg = self._encoder_cfg()
        tp = ctx.tp_axis if self.sharded and ctx.tp_size > 1 else None
        ta = (tp if tp and ecfg.num_heads % ctx.tp_size == 0
              and ecfg.num_kv_heads % ctx.tp_size == 0 else None)
        tm = tp if tp and ecfg.d_ff % ctx.tp_size == 0 else None

        def cut(t, dim, axis):
            return t if axis is None else ctx.take_block(t, dim, axis)
        x = frames.to(self.dtype)
        x, sp = self._residual_constraint(x, "prefill", ctx)

        def full(h):
            return h if sp is None else ctx.all_gather(h, sp, dim=1)

        def mine(y):
            return y if sp is None else ctx.take_block(y, 1, sp)
        for bp, spec in zip(params["encoder"]["blocks"],
                            self.specs["encoder"]["blocks"]):
            bp, _ = self._view(bp, spec)
            mx, ffn = bp["mixer"], bp["ffn"]
            h = full(rms_norm(x, bp["mixer_norm"], eps))
            q, k, v = (torch.einsum("bsd,dhk->bshk", h, cut(mx[n], 1, ta))
                       for n in ("wq", "wk", "wv"))
            o = naive_attention(q, k, v, causal=False)
            y = torch.einsum("bshk,hkd->bsd", o, cut(mx["wo"], 0, ta))
            x = x + mine(A._tp_sum(y, ctx, ta))
            h = full(rms_norm(x, bp["ffn_norm"], eps))
            local = {"wi_gate": cut(ffn["wi_gate"], 1, tm),
                     "wi_up": cut(ffn["wi_up"], 1, tm),
                     "wo": cut(ffn["wo"], 0, tm)}
            x = x + mine(F.mlp_apply(local, h, ctx=ctx, tp_axis=tm))
        x = full(x)
        return rms_norm(x, params["encoder"]["norm"], eps)

    # ------------------------------------------------------------------
    # public steps
    # ------------------------------------------------------------------
    def _unembed(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _unembed_local(self, params):
        """(this rank's block of the [d, V] unembedding, its spec)."""
        if self.cfg.tie_embeddings:
            sp = self.specs["embed"]
            return params["embed"].T, shd.PSpec(sp.entry(1), sp.entry(0))
        return params["lm_head"], self.specs["lm_head"]

    def _embed(self, params, tokens, ctx=None):
        """tokens [B, S] (this rank's rows) → [B, S, d]. On a mesh the
        table is this rank's block of the vocabulary (and of d, gathered):
        each rank looks up the ids in its block, zeros elsewhere, and a
        float32 ``psum`` over the vocab axes adds the one non-zero row —
        over the tokens of every rank of those axes that holds other
        rows, sliced back after."""
        if not self.sharded:
            return params["embed"][tokens].to(self.dtype)
        ctx = self.ctx if ctx is None else ctx
        spec = self.specs["embed"]
        table = shd.gather_local(params["embed"], spec, ctx, dims=(1,))
        ve = spec.entry(0)
        if ve is None:
            return table[tokens].to(self.dtype)
        ve_t = (ve,) if isinstance(ve, str) else tuple(ve)
        over = tuple(a for a in ve_t if a in ctx.batch_axes)
        if over:
            tokens = ctx.all_gather(tokens, over, dim=0)
        n_v = table.shape[0]
        local = tokens.long() - ctx.axis_index(ve) * n_v
        inside = (local >= 0) & (local < n_v)
        x = torch.where(inside[..., None], table[local.clamp(0, n_v - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
        x = ctx.psum(x.float(), ve).to(self.dtype)
        return ctx.take_block(x, 0, over) if over else x

    def _logits(self, params, h, ctx=None):
        """h [B, d] (this rank's rows) → logits [B_global, V] f32. On a
        mesh: the rows all-gathered over the batch axes, the product with
        this rank's block of the vocabulary, all-gathered over the vocab
        axes — so every rank holds the same logits."""
        if not self.sharded:
            return torch.matmul(h.float(), self._unembed(params).float())
        ctx = self.ctx if ctx is None else ctx
        w, spec = self._unembed_local(params)
        w = shd.gather_local(w, spec, ctx, dims=(0,))
        if ctx.batch_axes:
            h = ctx.all_gather(h, ctx.batch_axes, dim=0)
        logits = torch.matmul(h.float(), w.float())
        ve = spec.entry(1)
        return logits if ve is None else ctx.all_gather(logits, ve, dim=1)

    def _memory(self, params, memory, ctx=None, rows: bool = False):
        """What the cross-attention layers read, in the model's dtype:
        ``memory`` itself, or for an encoder-decoder the encoder's
        output on it (its frames). ``rows``: ``memory`` is a global batch
        and this rank keeps its block of the rows (under ``ctx``), as
        the steps cut their tokens."""
        if memory is None:
            raise ValueError(f"{self.cfg.name}: needs memory (its "
                             f"cross-attention layers read it)")
        (memory,) = self._rows(ctx, rows, memory.to(self.dtype))
        return (self.encode(params, memory, ctx) if self.cfg.is_encdec
                else memory)

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
        as :meth:`prefill`.

        On a mesh the inputs are global and each rank takes its rows, as
        :meth:`prefill`; the loss and every metric are the global ones,
        the same on every rank (the mean over every data rank's counted
        tokens; the MoE statistics reduced as the reference reduces
        them). Its gradient: seed ``1 / n`` on each of the ``n`` ranks of
        :meth:`train_axes`, then :meth:`reduce_grads`
        (``train_loop.loss_and_grads`` does both)."""
        ctx, rows = self._batch_ctx(tokens.shape[0])
        if self.has_cross:
            memory = self._memory(params, memory, ctx, rows)
        tokens, labels = self._rows(ctx, rows, tokens, labels)
        if loss_mask is not None:
            (loss_mask,) = self._rows(ctx, rows, loss_mask)
        x = self._embed(params, tokens, ctx)
        x, sp = self._residual_constraint(x, "train", ctx)
        x, _, (lb, z, counts) = self._apply_stack(
            params, x, mode="train", memory=memory, ctx=ctx, sp_axis=sp)
        nll, n_tok = self.train_nll(params, x, labels, loss_mask, ctx)
        loss = nll + lb + z
        return loss, {"nll": nll, "moe_lb_loss": lb, "moe_z_loss": z,
                      "tokens": n_tok, "expert_counts": counts}

    def train_nll(self, params, h, labels, mask=None, ctx=None):
        """h [B, S, d] (this rank's rows under ``ctx``), labels [B, S] →
        (the chunked cross-entropy's mean over the counted tokens of
        every data rank, their count). On a mesh the unembedding stays
        cut over its vocab axes (log-sum-exp through ``pmax`` / ``psum``)
        except those the rows are cut over, which are gathered."""
        if not self.sharded:
            return chunked_softmax_xent(h, labels, self._unembed(params),
                                        mask=mask)
        ctx = self.ctx if ctx is None else ctx
        w, spec = self._unembed_local(params)
        w = shd.gather_local(w, spec, ctx, dims=(0,))
        ve = shd.spec_axes(shd.PSpec(None, spec.entry(1)))
        rows = tuple(a for a in ve if a in ctx.batch_axes)
        if rows:
            w = ctx.all_gather(w, rows, dim=1)
        va = tuple(a for a in ve if a not in rows and ctx.axis_size(a) > 1)
        if va:
            tot, cnt = xent_sum(h, labels, w, mask, mc=ctx, axes=va,
                                v0=ctx.axis_index(va) * w.shape[1])
        else:
            tot, cnt = xent_sum(h, labels, w, mask)
        ba = ctx.batch_axes
        tot, cnt = ctx.psum(tot, ba), ctx.psum(cnt, ba)
        return tot / torch.clamp(cnt, min=1.0), cnt

    def train_axes(self) -> Tuple[str, ...]:
        """The mesh axes a training step spans: those the context names
        (batch, TP, EP, sequence) and those any parameter is cut over,
        in mesh order; a loss every rank computes alike is held by the
        ranks of these axes (a leading replica axis no collective names
        is not one)."""
        ctx = self.ctx
        named = set(ctx.named_axes)
        for sp in shd.leaves_by_path(self.specs).values():
            named.update(shd.spec_axes(sp))
        return tuple(a for a in ctx.axis_names if a in named
                     and ctx.axis_size(a) > 1)

    def reduce_grads(self, grads: PyTree, specs: PyTree = None) -> PyTree:
        """Each leaf's gradient (partials, as a backward seeded ``1 / n``
        leaves them) summed over the axes of :meth:`train_axes` that do
        not cut it, in float32: one all-reduce per group of leaves with
        the same axes. ``specs`` default: the whole model's. The identity
        on one device."""
        if not self.sharded:
            return grads
        ctx, axes = self.ctx, self.train_axes()
        flat_specs = shd.leaves_by_path(self.specs if specs is None
                                        else specs)
        flat = shd.leaves_by_path(grads)
        groups: Dict[tuple, list] = {}
        for keys in flat:
            cut = shd.spec_axes(flat_specs[keys])
            over = tuple(a for a in axes if a not in cut)
            if over:
                groups.setdefault(over, []).append(keys)
        for over, keys in groups.items():
            buf = torch.cat([flat[k].float().reshape(-1) for k in keys])
            buf = ctx._reduce(buf, over, "psum", "grad_sum")
            off = 0
            for k in keys:
                n = flat[k].numel()
                flat[k] = buf[off:off + n].view(flat[k].shape).to(
                    flat[k].dtype)
                off += n
        return shd.map_with_paths(grads, lambda k, _: flat[k])

    def prefill(self, params, tokens, *, memory=None, last_pos=None):
        """tokens [B, S] → (logits at ``last_pos`` (default S-1) [B, V]
        f32, cache). A model with cross-attention needs ``memory`` [B,
        M, md]: the frames its encoder runs on (``cfg.is_encdec``), else
        the memory itself; it is taken in the model's dtype. On a mesh
        each rank runs the encoder and the cross-attention layers on its
        rows of the memory, as on its rows of ``tokens``."""
        ctx, rows = self._batch_ctx(tokens.shape[0])
        if self.has_cross:
            memory = self._memory(params, memory, ctx, rows)
        (tokens,) = self._rows(ctx, rows, tokens)
        if last_pos is not None:
            (last_pos,) = self._rows(ctx, rows, last_pos)
        x = self._embed(params, tokens, ctx)
        x, sp = self._residual_constraint(x, "prefill", ctx)
        x, caches, _ = self._apply_stack(params, x, mode="prefill",
                                         memory=memory, ctx=ctx, sp_axis=sp)
        if last_pos is None:
            h = x[:, -1]
        else:
            h = x[torch.arange(x.shape[0], device=x.device), last_pos]
        return self._logits(params, h, ctx), caches

    def prefill_chunk(self, params, cache, tokens, offset: int, last_pos):
        """Run one contiguous chunk [B, S_chunk] of a prompt against the
        full-length cache buffers in ``cache`` (written in place at
        ``offset``). Returns (logits [B, V] at ``last_pos`` within the
        chunk, cache); on the final chunk these equal :meth:`prefill`'s.
        Decoder-only models without cross-attention."""
        if self.has_cross:
            raise ValueError(f"{self.cfg.name}: chunked prefill runs no "
                             f"cross-attention or encoder")
        ctx, rows = self._batch_ctx(tokens.shape[0])
        tokens, last_pos = self._rows(ctx, rows, tokens, last_pos)
        x = self._embed(params, tokens, ctx)
        x, sp = self._residual_constraint(x, "chunk", ctx)
        x, cache, _ = self._apply_stack(params, x, mode="chunk",
                                        caches=cache, positions=int(offset),
                                        ctx=ctx, sp_axis=sp)
        h = x[torch.arange(x.shape[0], device=x.device), last_pos]
        return self._logits(params, h, ctx), cache

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
        ctx, rows = self._batch_ctx(tokens.shape[0])
        tokens, positions = self._rows(ctx, rows, tokens, positions)
        x = self._embed(params, tokens, ctx)
        x, cache, _ = self._apply_stack(params, x, mode="decode",
                                        caches=cache, positions=positions,
                                        placement=placement, ctx=ctx)
        return self._logits(params, x[:, -1], ctx), x[:, -1:], cache

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
        only this: eager PyTorch would run a discarded ``_logits``.

        On a mesh the head's block runs under the model's ``ctx`` and
        rules like a main-stack block: ``next_tokens`` and ``positions``
        are global, as :meth:`decode_step_hidden` takes them; ``hidden``,
        the new hidden and ``mtp_cache`` (``init_mtp_cache(local=True)``)
        are this rank's rows, as that step returns them."""
        cfg = self.cfg
        ctx, rows = self._batch_ctx(next_tokens.shape[0])
        next_tokens, = self._rows(ctx, rows, next_tokens)
        if mtp_cache is not None:
            positions, = self._rows(ctx, rows, positions)
        mp, spec = self._view(params["mtp"][mtp_index],
                              self.specs["mtp"][mtp_index])
        e = self._embed(params, next_tokens, ctx)
        h = torch.cat([rms_norm(hidden, mp["norm_h"], cfg.norm_eps),
                       rms_norm(e, mp["norm_e"], cfg.norm_eps)], dim=-1)
        h = torch.matmul(h, mp["proj"])
        mode = "decode" if mtp_cache is not None else "train"
        h, cache, _ = block_apply(mp["block"], h, cfg=cfg, kind=self.mtp_kind,
                                  mode=mode, cache=mtp_cache,
                                  positions=positions, ctx=ctx,
                                  specs=None if spec is None
                                  else spec["block"])
        return h, (None if mtp_cache is None else cache)

    def mtp_step(self, params, mtp_index: int, hidden, next_tokens,
                 positions, mtp_cache=None):
        """:meth:`mtp_hidden` and the draft logits: → (logits [B, V] f32,
        new hidden [B, 1, d], cache). On a mesh the logits are global
        (all-gathered, the same on every rank), the hidden this rank's
        rows."""
        h, cache = self.mtp_hidden(params, mtp_index, hidden, next_tokens,
                                   positions, mtp_cache)
        ctx, _ = self._batch_ctx(next_tokens.shape[0])
        return self._logits(params, h[:, -1], ctx), h, cache

    def batch_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor ``t`` (dim 0), cut as
        the steps cut their inputs: ``t`` itself on one device or where
        the batch does not divide the batch axes."""
        ctx, rows = self._batch_ctx(t.shape[0])
        return self._rows(ctx, rows, t)[0]


def build_model(cfg: ModelConfig, ctx, long_context: bool = False,
                rules=None) -> Model:
    """The reference's entry: a model on ``ctx`` (its ``remat`` and
    ``decode_microbatches`` too)."""
    return Model(cfg, ctx=ctx, rules=rules, long_context=long_context,
                 remat=ctx.remat)


def seeded_memory(cfg: ModelConfig, generator: torch.Generator, device,
                  dtype=torch.float32) -> torch.Tensor:
    """[1, num_frontend_tokens, md] standard normal from ``generator``:
    what the stubbed frontends give a model with cross-attention (a
    VLM's patch embeddings, an encoder-decoder's frames)."""
    md = cfg.encoder_d_model or cfg.d_model
    return torch.randn((1, cfg.num_frontend_tokens, md), generator=generator,
                       device=device, dtype=dtype)
