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
implementation buffers the chunks and runs one monolithic ``prefill``.

The ``apply_placement`` contract — the EPLB data plane
------------------------------------------------------

``apply_placement(table)`` installs a
:class:`~repro_torch.serving.eplb.PlacementTable` that every later
decode iteration routes through (``None`` reverts to logical routing).
Callers never invoke it while a decode step is in flight —
``DPGroup.apply_placement`` defers the swap to the next
``decode_complete`` boundary. Prefill and chunked prefill always route
logically, as in the reference.

Not yet ported (a later slice): the prefix-KV trio
(``slice_prefill_kv`` / ``seed_prefill_cache`` / ``read_remote_kv``);
``supports_prefix_kv`` is False.
"""
from __future__ import annotations

import abc
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import resolve_device, tree_map
from repro_torch.serving.sampling import (DRAFT, greedy_verify,
                                          sample_tokens, speculative_verify,
                                          step_generator)
from repro_torch.serving.tokenizer import PAD

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
    #: prefix-KV seeding is not ported yet
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
    drafts per iteration; it needs a model with an MTP head."""

    supports_chunked_prefill = True

    def __init__(self, model, params: PyTree, *, max_len: int = 256,
                 seed: int = 0, top_k: int = 0, mtp_k: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.max_len = max_len
        self.seed = seed
        self.top_k = top_k
        self.mtp_k = int(mtp_k)
        if self.mtp_k and "mtp" not in params:
            raise ValueError(
                f"mtp_k={mtp_k} requires a model with an MTP head "
                f"(cfg.mtp_num_layers > 0)")
        self.vocab_size = model.cfg.vocab_size
        self._placement = None

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def init_cache(self, max_batch: int, max_len: int) -> PyTree:
        return self.model.init_cache(max_batch, max_len, device=self.device)

    @torch.no_grad()
    def prefill(self, tokens: List[int]) -> Tuple[PyTree, np.ndarray]:
        n = len(tokens)
        Lp = min(_bucket_len(n), self.max_len)
        padded = list(tokens) + [PAD] * (Lp - n)
        logits, cache = self.model.prefill(
            self.params, self._ints(padded)[None], self._ints([n - 1]))
        return cache, logits[0].float().cpu().numpy()

    @torch.no_grad()
    def prefill_chunk(self, cache, tokens: List[int], offset: int,
                      total_len: int):
        """One chunk over the full-length cache buffer (written in place),
        padded to its bucket exactly as the reference pads it: the pad
        tokens go through the router too."""
        Lc = min(_bucket_len(max(total_len, 1)), self.max_len)
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

    @torch.no_grad()
    def write_slot(self, cache: PyTree, cache1: PyTree,
                   slot: int) -> PyTree:
        """Copy a batch-1 cache (any length up to the slot's) into slot
        ``slot`` in place; the slot's positions past it are zeroed."""
        def one(full, part, stacked):
            # per-layer leaves are [B, L, ...] (MLA latents, GQA k/v),
            # stacked ones [n_sb, B, L, ...]
            dst = full[:, slot] if stacked else full[slot]
            src = part[:, 0] if stacked else part[0]
            ax = 1 if stacked else 0
            dst.zero_()
            dst.narrow(ax, 0, src.shape[ax]).copy_(src.to(dst.dtype))
        _map_pairs(one, cache, cache1)
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
        return self.model.init_mtp_cache(max_batch, max_len,
                                         device=self.device)

    @torch.no_grad()
    def reset_mtp_slot(self, mtp_cache: PyTree, slot: int) -> PyTree:
        for t in (*mtp_cache["kv"].values(), mtp_cache["hidden"]):
            t[slot].zero_()
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
        # input when the next iteration drafts from the emitted token
        hs = torch.cat(hiddens, dim=1)
        rows = torch.arange(hs.shape[0], device=self.device)
        mtp_cache["hidden"].copy_(hs[rows, n_acc.long()][:, None])
        return block, n_acc, cache, mtp_cache
