"""Execution backends: the seam between the serving control plane and
model execution.

A :class:`~repro_torch.serving.dp_group.DPGroup` owns admission, KV
accounting, prefix statistics, slot management and sampling; the
forward passes and the cache representation go through an
:class:`ExecutionBackend`. :class:`TorchBackend` runs a
:class:`~repro_torch.models.transformer.Model` on one device.

The ``decode_sample`` contract — the zero-sync decode fast path
---------------------------------------------------------------

``decode_sample(cache, tokens, positions, temperatures, step)`` runs ONE
decode iteration **and** the token sampling on the device, returning
``(next_tokens, new_cache)`` where ``next_tokens`` is a ``[B]`` int32
tensor on the backend's device — the caller fetches it when needed, so
the only device→host traffic per step is 4 bytes per slot, never a
``[B, V]`` logits plane.

* ``tokens`` int32 ``[B, 1]``, ``positions`` int32 ``[B]``,
  ``temperatures`` f32 ``[B]`` (``<= 0`` ⇒ greedy per slot), ``step``
  an int identifying the engine iteration: the sampling stream is a pure
  function of ``(backend seed, step)``, so replays are deterministic.
* The returned ``new_cache`` replaces the caller's handle. With
  ``donate=True`` (default) KV is updated in place in the caller's
  buffers; ``donate=False`` leaves them untouched (the §6.2 rollback
  keeps the pre-step cache) and writes a copy.

The ``decode_sample_mtp`` contract — speculative decoding (§4.6)
----------------------------------------------------------------

``decode_sample_mtp(cache, mtp_cache, tokens, positions, temperatures,
step)`` is the multi-token sibling of ``decode_sample``: it runs the MTP
draft head ``k = mtp_k`` times (chained through its own decode cache),
the main model's verify chain over ``[token, draft_1, …, draft_k]``
(``k + 1`` decode steps of ``decode_sample``'s shapes) and the
acceptance step on the device
(:func:`~repro_torch.serving.sampling.speculative_verify`). It returns
``(token_block [B, k+1] int32, n_accepted [B] int32, cache,
mtp_cache)``; slot ``i`` emits ``token_block[i, :n_accepted[i] + 1]``.

* Host traffic stays ``4·B·(k+1) + 4·B`` bytes (token ids and accepted
  counts), never logits.
* Greedy slots accept a draft iff it equals the main model's argmax and
  emit only argmaxes (lossless); stochastic slots use the rejection rule,
  the residual resample and the bonus token, with every draw from a
  stream of ``(seed, step)``: re-executing a step replays it.
* Both caches are updated in place; ``donate=False`` clones both first
  (the §6.2 rollback keeps the pre-step handles).
* The verify chain writes KV at ``positions + j`` (clamped to the
  buffer). Rejected positions hold junk that decode attention never
  reads (it masks slots past each row's position) and that later steps
  overwrite; likewise in the head's cache. ``reset_mtp_slot`` zeroes a
  slot's head state at admission (the ``write_slot`` analogue).
* ``mtp_cache`` is ``{"kv": the head block's decode cache, "hidden":
  [B, 1, d]}``, the hidden being the main model's final hidden at each
  slot's last accepted position.
* A backend advertises the path with ``mtp_k > 0``.

The ``prefill_chunk`` contract — chunked prefill
------------------------------------------------

``prefill_chunk(cache, tokens, offset, total_len)`` runs ONE contiguous
chunk of a prompt's prefill and returns ``(cache, logits)``: pass
``cache=None`` on the first chunk (``offset == 0``) and thereafter the
handle the previous chunk returned; ``logits`` are the chunk's last
valid position, equal to ``prefill``'s on the final chunk. The default
implementation buffers the chunks and runs one monolithic ``prefill``;
``TorchBackend`` runs chunks incrementally only where every mixer
attends globally (``supports_chunked_prefill``): a ring window or a
recurrent state cannot resume a prompt mid-way, so those models buffer.

The ``apply_placement`` contract — the EPLB data plane
------------------------------------------------------

``apply_placement(table)`` installs a
:class:`~repro_torch.serving.eplb.PlacementTable` that every later
decode iteration routes through (``None`` reverts to logical routing).
Callers never invoke it while a decode step is in flight —
``DPGroup.apply_placement`` defers the swap to the next
``decode_complete`` boundary. Prefill and chunked prefill always route
logically, as in the reference.

The prefix-KV contract — radix-cache seeding
--------------------------------------------

``slice_prefill_kv(cache, tokens, start, end)`` copies the KV payload of
token range ``[start, end)`` out of a batch-1 prefill cache, and
``seed_prefill_cache(payloads, prefix_len, total_len)`` builds a fresh
partial-prefill cache whose first ``prefix_len`` positions hold those
payloads: the handle ``prefill_chunk`` accepts at ``offset ==
prefix_len``. On insert the ``DPGroup`` slices one payload per KV block
into its radix tree; on a hit it seeds from the stored blocks and runs
only the suffix.

* ``payloads`` are consecutive block slices covering ``[0,
  prefix_len)`` in order.
* The seeded cache has the buffer length ``prefill_chunk(None, …)``
  allocates for ``total_len``, so the suffix chunk runs the programs a
  cold chunk at that offset runs: with the same split (a cold chunk
  ending at ``prefix_len``), its logits and valid-region KV are
  bit-identical to the cold prefill's. Against a cold prefill split
  elsewhere they are the same function only where no MoE capacity
  drops a token (capacity is set per call from the chunk's token count)
  and the products' kernels do not change with the row count.
* Payloads and seeded buffers are fresh tensors, never views of a
  prefill buffer that a later chunk writes in place.
* ``supports_prefix_kv`` gates the path; it equals
  ``supports_chunked_prefill``.
* **Cross-DP reads (pod-pooled prefix KV).** With a
  :class:`~repro_torch.serving.kv_cache.PodKVDirectory`, a DP group that
  misses locally pins another group's cached prefix
  (``PodKVDirectory.acquire``) and pulls the stored blocks through
  ``read_remote_kv`` (``xccl/pd_transfer.ub_read``: on one card a
  device-to-device copy), bit-identical to the owner's payloads. The
  owner's blocks stay pinned until the borrower releases the pin, on
  completion or on any cancel path, exactly once.
"""
from __future__ import annotations

import abc
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN, MLA_ATTN
from repro_torch.launch import sharding as shd
from repro_torch.models.common import resolve_device, tree_map
from repro_torch.serving.sampling import (DRAFT, greedy_verify,
                                          sample_tokens, speculative_verify,
                                          step_generator)
from repro_torch.serving.tokenizer import PAD
from repro_torch.xccl.pd_transfer import (assemble_chunks, slice_kv_chunk,
                                          ub_read)

PyTree = Any


class ExecutionBackend(abc.ABC):
    """Model-execution contract consumed by ``DPGroup``."""

    #: vocab size of the logits this backend produces.
    vocab_size: int

    @abc.abstractmethod
    def init_cache(self, max_batch: int, max_len: int) -> PyTree:
        """Allocate the decode cache for ``max_batch`` slots."""

    @abc.abstractmethod
    def prefill(self, tokens: List[int]) -> Tuple[PyTree, np.ndarray]:
        """Run the prefill forward for one prompt. Returns ``(batch-1
        cache, last-position logits [V])``."""

    #: True when ``prefill_chunk`` executes incrementally; False ⇒ the
    #: buffering default below.
    supports_chunked_prefill: bool = False
    #: True when the backend can slice per-block KV payloads and seed a
    #: partial-prefill cache from them (the prefix-KV contract)
    supports_prefix_kv: bool = False

    def prefill_chunk(self, cache: Optional[PyTree], tokens: List[int],
                      offset: int, total_len: int
                      ) -> Tuple[PyTree, Optional[np.ndarray]]:
        """Run one contiguous prefill chunk (module docstring). Default:
        accumulate the chunk tokens and run :meth:`prefill` once the
        final chunk arrives."""
        if cache is None:
            if offset != 0:
                raise ValueError("first chunk must start at offset 0")
            cache = {"_chunk_tokens": []}
        buf = cache["_chunk_tokens"]
        if offset != len(buf):
            raise ValueError(
                f"non-contiguous chunk: offset {offset} != {len(buf)}")
        buf.extend(tokens)
        if len(buf) >= total_len:
            return self.prefill(buf)
        return cache, None

    def slice_prefill_kv(self, cache: PyTree, tokens: List[int],
                         start: int, end: int) -> PyTree:
        """The KV payload of token range ``[start, end)`` of a batch-1
        prefill cache (``tokens`` is the full prompt)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support prefix-KV slicing")

    def seed_prefill_cache(self, payloads: List[PyTree], prefix_len: int,
                           total_len: int) -> PyTree:
        """A partial-prefill cache whose ``[0, prefix_len)`` holds the
        given consecutive block payloads; valid ``prefill_chunk`` input
        at ``offset == prefix_len``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support prefix-KV seeding")

    def read_remote_kv(self, payloads: List[PyTree]) -> List[PyTree]:
        """Pull another DP group's stored block payloads (the UB read of
        the pod-pooled prefix cache, ``xccl/pd_transfer.ub_read``):
        fresh tensors, bit-identical to the owner's."""
        return [ub_read(p) for p in payloads]

    @abc.abstractmethod
    def write_slot(self, cache: PyTree, cache1: PyTree,
                   slot: int) -> PyTree:
        """Insert a batch-1 prefill cache into batch slot ``slot``."""

    @abc.abstractmethod
    def decode(self, cache: PyTree, tokens: np.ndarray,
               positions: np.ndarray) -> Tuple[np.ndarray, PyTree]:
        """One decode step over all slots (diagnostic / logits path).
        Returns ``(logits [B, V], new cache)``."""

    @abc.abstractmethod
    def decode_sample(self, cache: PyTree, tokens: np.ndarray,
                      positions: np.ndarray, temperatures: np.ndarray,
                      step: int, *, donate: bool = True
                      ) -> Tuple[Any, PyTree]:
        """One decode iteration + on-device sampling (fast path).
        Returns ``(next_tokens [B] int32, new cache)``."""

    #: MTP draft tokens per decode iteration; 0 ⇒ speculative decoding
    #: off (``decode_sample_mtp`` unavailable)
    mtp_k: int = 0

    def init_mtp_cache(self, max_batch: int, max_len: int) -> PyTree:
        """Allocate the batched MTP draft-head state (``mtp_k > 0``)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support MTP decoding")

    def reset_mtp_slot(self, mtp_cache: PyTree, slot: int) -> PyTree:
        """Zero slot ``slot`` of the draft-head state at admission.
        Returns the handle to use from then on."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support MTP decoding")

    def decode_sample_mtp(self, cache: PyTree, mtp_cache: PyTree,
                          tokens: np.ndarray, positions: np.ndarray,
                          temperatures: np.ndarray, step: int, *,
                          donate: bool = True
                          ) -> Tuple[Any, Any, PyTree, PyTree]:
        """One propose-then-verify MTP iteration (module docstring).
        Returns ``(token_block [B, mtp_k+1] int32, n_accepted [B] int32,
        cache, mtp_cache)``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support MTP decoding")

    def apply_placement(self, table: Optional[Any]) -> None:
        """Install the EPLB placement later decode iterations route
        through (``None`` ⇒ logical routing). Default: no-op."""


def _bucket_len(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 2048) * 2048


def _map_pairs(fn, full, one):
    """Apply ``fn(full_leaf, one_leaf, stacked)`` over two cache trees of
    the model's layout (``stacked`` for the ``blocks`` leaves)."""
    for section, sub in full.items():
        if section == "blocks":
            for pos, leaves in sub.items():
                for n, t in leaves.items():
                    fn(t, one[section][pos][n], True)
        else:
            for i, leaves in enumerate(sub):
                for n, t in leaves.items():
                    fn(t, one[section][i][n], False)


class TorchBackend(ExecutionBackend):
    """Eager decode + bucketed-length prefill over a model on one device.

    The decode hot loop is :meth:`decode_sample`: forward + sampling on
    the device with the cache updated in place, returning only ``[B]``
    int32 token ids. Several backends may share one parameter set.
    ``top_k > 0`` truncates sampling at temperature > 0 to each row's
    ``top_k`` highest logits, as the reference's ``JAXBackend`` does.
    ``mtp_k > 0`` turns on :meth:`decode_sample_mtp` with that many
    drafts per iteration; it needs a model with an MTP head. ``memory``
    [B, M, md]: what a model with cross-attention reads (a VLM's patch
    embeddings, an encoder-decoder's frames), moved to the device; each
    prefill takes its first row, as the reference's ``JAXBackend``.

    On a mesh (the model's ``ctx``) each rank runs its own backend on the
    same inputs: the decode cache and the MTP head's state are this
    rank's blocks (``init_cache``, ``write_slot``, ``init_mtp_cache``,
    ``reset_mtp_slot``), the logits come back all-gathered, so every
    rank draws the same tokens and drafts and accepts the same counts.
    Prefix-KV payloads and seeded caches are the chunk buffer's layout
    (batch 1, every slot and KV head: the same global tensors on every
    rank), so the radix tree is the same on every rank."""

    def __init__(self, model, params: PyTree, *, max_len: int = 256,
                 memory: Optional[torch.Tensor] = None, seed: int = 0,
                 top_k: int = 0, mtp_k: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.max_len = max_len
        self.memory = None if memory is None else memory.to(self.device)
        self.seed = seed
        self.top_k = top_k
        self.mtp_k = int(mtp_k)
        if self.mtp_k and "mtp" not in params:
            raise ValueError(
                f"mtp_k={mtp_k} requires a model with an MTP head "
                f"(cfg.mtp_num_layers > 0)")
        self.vocab_size = model.cfg.vocab_size
        self._placement = None
        self._cache_batch = self._mtp_batch = 0

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def init_cache(self, max_batch: int, max_len: int) -> PyTree:
        """The decode cache; on a mesh in the decode layout (this rank's
        slots)."""
        self._cache_batch = max_batch
        return self.model.init_cache(max_batch, max_len, device=self.device,
                                     local=True)

    @torch.no_grad()
    def prefill(self, tokens: List[int]) -> Tuple[PyTree, np.ndarray]:
        n = len(tokens)
        Lp = min(_bucket_len(n), self.max_len)
        padded = list(tokens) + [PAD] * (Lp - n)
        logits, cache = self.model.prefill(
            self.params, self._ints(padded)[None],
            memory=None if self.memory is None else self.memory[:1],
            last_pos=self._ints([n - 1]))
        return cache, logits[0].float().cpu().numpy()

    @property
    def supports_chunked_prefill(self) -> bool:
        """True when every mixer attends globally (ATTN / MLA_ATTN) in a
        decoder-only model with no ``window_override``, the reference's
        rule: ring windows and recurrent states cannot resume a prefill
        mid-prompt, so those models take the buffering default."""
        cfg = self.model.cfg
        return (not cfg.is_encdec and self.model.window_override == 0
                and all(m in (ATTN, MLA_ATTN)
                        for m, _ in cfg.layer_kinds()))

    @torch.no_grad()
    def prefill_chunk(self, cache, tokens: List[int], offset: int,
                      total_len: int):
        """One chunk over the full-length cache buffer (written in place),
        padded to its bucket exactly as the reference pads it: the pad
        tokens go through the router too. Without incremental prefill
        (``supports_chunked_prefill``), the buffering default."""
        if not self.supports_chunked_prefill:
            return super().prefill_chunk(cache, tokens, offset, total_len)
        Lc = self._chunk_buffer_len(total_len)
        if cache is None:
            if offset != 0:
                raise ValueError("first chunk must start at offset 0")
            cache = self.model.init_cache(1, Lc, device=self.device)
        n = len(tokens)
        Sc = min(_bucket_len(max(n, 1)), Lc - offset)
        padded = list(tokens) + [PAD] * (Sc - n)
        logits, cache = self.model.prefill_chunk(
            self.params, cache, self._ints(padded)[None], offset,
            self._ints([n - 1]))
        return cache, logits[0].float().cpu().numpy()

    def _chunk_buffer_len(self, total_len: int) -> int:
        """The cache length a prompt of ``total_len`` tokens prefills in:
        ``prefill_chunk`` allocates it and ``seed_prefill_cache`` seeds
        it, so a seeded suffix runs the shapes of a cold chunk."""
        return min(_bucket_len(max(total_len, 1)), self.max_len)

    @property
    def supports_prefix_kv(self) -> bool:
        """Seeding rides the incremental-prefill machinery, on one device
        and on a mesh (the reference's rule)."""
        return self.supports_chunked_prefill

    def slice_prefill_kv(self, cache: PyTree, tokens: List[int],
                         start: int, end: int) -> PyTree:
        # a copy: the radix tree keeps it past the prefill buffer's life
        return slice_kv_chunk(cache, start, end)

    @torch.no_grad()
    def seed_prefill_cache(self, payloads: List[PyTree], prefix_len: int,
                           total_len: int) -> PyTree:
        """Copy the payloads into ``[0, prefix_len)`` of a fresh cache of
        the buffer length a cold chunked prefill of ``total_len`` tokens
        allocates; the chunks then write only positions past their
        offset, so the seeded region survives bit-exactly. On a mesh the
        fresh cache is the chunk buffer ``prefill_chunk`` allocates (the
        prefill layout: batch 1 and every slot), never a decode block."""
        fresh = self.model.init_cache(1, self._chunk_buffer_len(total_len),
                                      device=self.device)
        kv = assemble_chunks(list(payloads))

        def one(full, part, stacked):
            ax = 2 if stacked else 1
            full.narrow(ax, 0, prefix_len).copy_(part.narrow(ax, 0,
                                                             prefix_len))
        _map_pairs(one, fresh, kv)
        return fresh

    @torch.no_grad()
    def write_slot(self, cache: PyTree, cache1: PyTree,
                   slot: int) -> PyTree:
        """Copy a batch-1 cache into slot ``slot`` in place, the
        reference's pad-to-slot rule: each leaf is zero-padded at the end
        of every axis up to the slot's shape (a prefill's [S, ...] K/V or
        ring into the slot's [L, ...], a memory's [M, ...] cross K/V into
        the slot's ``num_frontend_tokens``; a recurrent ``state`` or
        ``conv`` history has the slot's shape already) and cast to its
        dtype. On a mesh the decode cache is this rank's block: the rank
        that owns the slot's row writes its block of the slots, and the
        others write nothing."""
        if self.model.sharded:
            return self._write_slot_sharded(cache, cache1, slot)

        def one(full, part, stacked):
            # the batch axis: 1 in stacked leaves [n_sb, B, ...], else 0
            dst = full[:, slot] if stacked else full[slot]
            src = part[:, 0] if stacked else part[0]
            if src.dim() != dst.dim() or any(
                    s > d for s, d in zip(src.shape, dst.shape)):
                raise ValueError(f"write_slot: a {tuple(src.shape)} leaf "
                                 f"does not fit a {tuple(dst.shape)} slot")
            dst.zero_()
            dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
        _map_pairs(one, cache, cache1)
        return cache

    def _write_slot_sharded(self, cache: PyTree, cache1: PyTree,
                            slot: int) -> PyTree:
        model = self.model
        slot = self._local_slot(slot, self._cache_batch)
        if slot is None:
            return cache
        src_of = shd.leaves_by_path(cache1)

        def one(keys, full):
            stacked = "blocks" in keys
            dst = full[:, slot] if stacked else full[slot]
            src = src_of[keys]
            src = src[:, 0] if stacked else src[0]
            ax = 1 if stacked else 0         # the slots, in dst and src
            axis = model.slot_axis(keys)
            s0 = 0 if axis is None else \
                model.ctx.axis_index(axis) * dst.shape[ax]
            n = max(0, min(src.shape[ax] - s0, dst.shape[ax]))
            src = src.narrow(ax, min(s0, src.shape[ax]), n)
            if src.dim() != dst.dim() or any(
                    s > d for s, d in zip(src.shape, dst.shape)):
                raise ValueError(f"write_slot: a {tuple(src.shape)} leaf "
                                 f"does not fit a {tuple(dst.shape)} slot")
            dst.zero_()
            dst[tuple(slice(0, m) for m in src.shape)].copy_(src)
        shd.map_with_paths(cache, one)
        return cache

    def apply_placement(self, table: Optional[Any]) -> None:
        """Install ``table`` with its arrays on this backend's device.
        Safe only between decode iterations (``DPGroup`` guarantees it)."""
        if table is None:
            self._placement = None
            return
        from repro_torch.serving.eplb import PlacementTable

        arrays = [np.asarray(a) for a in (table.replica_slots,
                                          table.n_replicas,
                                          table.phys_owner)]
        slots, n_rep, owner = arrays
        # the kernels index with these ids: check them here, on the host
        if (owner.min() < 0 or owner.max() >= slots.shape[1]
                or slots.min() < 0 or slots.max() >= owner.shape[1]
                or n_rep.min() < 1):
            raise ValueError("placement table holds an out-of-range id")
        self._placement = PlacementTable(
            *(torch.as_tensor(a, dtype=torch.int32, device=self.device)
              for a in arrays))

    @torch.no_grad()
    def decode(self, cache: PyTree, tokens: np.ndarray,
               positions: np.ndarray) -> Tuple[np.ndarray, PyTree]:
        logits, cache = self.model.decode_step(
            self.params, cache, self._ints(tokens), self._ints(positions),
            placement=self._placement)
        return logits.float().cpu().numpy(), cache

    @torch.no_grad()
    def decode_sample(self, cache: PyTree, tokens: np.ndarray,
                      positions: np.ndarray, temperatures: np.ndarray,
                      step: int, *, donate: bool = True
                      ) -> Tuple[Any, PyTree]:
        if not donate:
            cache = tree_map(torch.clone, cache)
        logits, cache = self.model.decode_step(
            self.params, cache, self._ints(tokens), self._ints(positions),
            placement=self._placement)
        temps = np.asarray(temperatures, np.float32)
        if np.any(temps > 0.0):
            toks = sample_tokens(
                logits, torch.as_tensor(temps, device=self.device),
                step_generator(self.seed, step, self.device),
                top_k=self.top_k)
        else:
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
        return toks, cache

    # ------------------------------------------------------------------
    # MTP speculative decoding (§4.6)
    # ------------------------------------------------------------------
    def init_mtp_cache(self, max_batch: int, max_len: int) -> PyTree:
        """The head's state; on a mesh in the decode layout (this rank's
        slots and block of positions), as :meth:`init_cache`."""
        self._mtp_batch = max_batch
        return self.model.init_mtp_cache(max_batch, max_len,
                                         device=self.device, local=True)

    def _local_slot(self, slot: int, B: int) -> Optional[int]:
        """Row of global slot ``slot`` in this rank's block of a decode
        state of ``B`` slots, or None when another rank's block holds it
        (one device: the slot itself)."""
        ctx = self.model.ctx
        if self.model.sharded and ctx.dp_size > 1 and B % ctx.dp_size == 0:
            b_loc = B // ctx.dp_size
            if slot // b_loc != ctx.axis_index(ctx.batch_axes):
                return None
            return slot % b_loc
        return slot

    @torch.no_grad()
    def reset_mtp_slot(self, mtp_cache: PyTree, slot: int) -> PyTree:
        """Zero the slot's head state; on a mesh only the rank whose block
        holds the slot writes (its row, its block of positions)."""
        row = self._local_slot(slot, self._mtp_batch)
        if row is not None:
            for t in (*mtp_cache["kv"].values(), mtp_cache["hidden"]):
                t[row].zero_()
        return mtp_cache

    def _positions(self, positions: torch.Tensor, j: int) -> torch.Tensor:
        """Positions ``+ j``, clamped to the buffer: a slot that close to
        ``max_len`` finishes before the clamped junk is consumed."""
        return torch.clamp(positions + j, max=self.max_len - 1)

    def _mtp_draft(self, mtp_cache, tokens, positions, temps, step: int,
                   stochastic: bool):
        """The draft chain: the head ``k`` times on its own hidden, each
        pass extending its decode cache. → (drafts, their logits), ``k``
        each of [B] and [B, V]."""
        gen = (step_generator(self.seed, step, self.device, DRAFT)
               if stochastic else None)
        hid, tok = mtp_cache["hidden"], tokens
        drafts, dlogits = [], []
        for j in range(self.mtp_k):
            dl, hid, _ = self.model.mtp_step(
                self.params, 0, hid, tok, self._positions(positions, j),
                mtp_cache["kv"])
            d = (sample_tokens(dl, temps, gen, top_k=self.top_k)
                 if stochastic else torch.argmax(dl, dim=-1).to(torch.int32))
            drafts.append(d)
            dlogits.append(dl)
            tok = d[:, None]
        return drafts, dlogits

    def _mtp_verify(self, cache, tokens, positions, drafts):
        """The verify chain: ``k + 1`` main decode steps of
        ``decode_sample``'s op sequence, on the committed token then each
        draft. → (logits [B, k+1, V], the ``k + 1`` final hiddens)."""
        logits, hiddens, tok = [], [], tokens
        for j in range(self.mtp_k + 1):
            lg, h, _ = self.model.decode_step_hidden(
                self.params, cache, tok, self._positions(positions, j),
                placement=self._placement)
            logits.append(lg)
            hiddens.append(h)
            if j < self.mtp_k:
                tok = drafts[j][:, None]
        return torch.stack(logits, dim=1), hiddens

    def _mtp_fill(self, mtp_cache, hiddens, drafts, positions) -> None:
        """Rewrite the head's KV at positions + 1 .. positions + k from
        the MAIN hiddens, so accepted positions hold canonical content
        next iteration (rejected ones hold junk that later passes
        overwrite before it is attended). Logits are not computed."""
        for j in range(self.mtp_k):
            self.model.mtp_hidden(self.params, 0, hiddens[j],
                                  drafts[j][:, None],
                                  self._positions(positions, j + 1),
                                  mtp_cache["kv"])

    @torch.no_grad()
    def decode_sample_mtp(self, cache: PyTree, mtp_cache: PyTree,
                          tokens: np.ndarray, positions: np.ndarray,
                          temperatures: np.ndarray, step: int, *,
                          donate: bool = True
                          ) -> Tuple[Any, Any, PyTree, PyTree]:
        if not self.mtp_k:
            raise NotImplementedError("backend built with mtp_k=0")
        if not donate:
            cache = tree_map(torch.clone, cache)
            mtp_cache = tree_map(torch.clone, mtp_cache)
        temps = np.asarray(temperatures, np.float32)
        stochastic = bool(np.any(temps > 0.0))
        toks, pos = self._ints(tokens), self._ints(positions)
        t = torch.as_tensor(temps, device=self.device)
        drafts, dlogits = self._mtp_draft(mtp_cache, toks, pos, t, step,
                                          stochastic)
        main_logits, hiddens = self._mtp_verify(cache, toks, pos, drafts)
        if stochastic:
            block, n_acc = speculative_verify(
                main_logits, torch.stack(drafts, dim=1),
                torch.stack(dlogits, dim=1), t, self.seed, step,
                top_k=self.top_k)
        else:
            block, n_acc = greedy_verify(main_logits,
                                         torch.stack(drafts, dim=1))
        self._mtp_fill(mtp_cache, hiddens, drafts, pos)
        # carry the hidden at the last ACCEPTED position: the head's
        # input when the next iteration drafts from the emitted token (on
        # a mesh the hiddens are this rank's rows: index with its rows of
        # the global counts)
        hs = torch.cat(hiddens, dim=1)
        rows = torch.arange(hs.shape[0], device=self.device)
        mine = self.model.batch_rows(n_acc).long()
        mtp_cache["hidden"].copy_(hs[rows, mine][:, None])
        return block, n_acc, cache, mtp_cache
