"""Self-contained DP group (§4.2): one full serving pipeline.

Each DP group owns tokenization, a paged KV allocator, an RTC prefix
cache, proactive GC, and an output-shortcutting worker that detokenizes
and streams tokens straight to the caller — no cross-DP communication
anywhere in the data path. The TE-shell only dispatches requests and
reads status.

Model execution (prefill forward, decode step, cache layout) is behind
an :class:`~repro_torch.serving.backend.ExecutionBackend`; the engine
injects a :class:`~repro_torch.serving.backend.TorchBackend`.

The decode hot loop is the zero-sync fast path: ``decode_launch()``
issues the backend's decode+sample step (cache updated in place, kernels
queued on the device without waiting) and ``decode_complete()`` fetches
only the ``[B]`` int32 next-token vector — 4 bytes per slot crossing
device→host per iteration, never a ``[B, V]`` logits plane (guarded by
tests). With MTP speculative decoding (§4.6, a backend with ``mtp_k >
0``) one iteration is the backend's ``decode_sample_mtp``, and
``4·B·(k+1) + 4·B`` bytes cross: the token block and the accepted
counts.

Not yet ported (a later slice): prefix-KV seeding from the radix cache
(the tree here keeps hit statistics only) and the pod-pooled KV
directory.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.backend import ExecutionBackend
from repro_torch.serving.gc_control import ProactiveGC, pin_to_core
from repro_torch.serving.kv_cache import BlockAllocator, RadixTree
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import DPStatus
from repro_torch.serving.tokenizer import PAD, ByteTokenizer

PyTree = Any


def to_host(t) -> np.ndarray:
    """The one device→host copy of a decode step (a ``[B]`` tensor)."""
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


@dataclasses.dataclass
class Slot:
    req: Optional[Request] = None
    next_token: int = PAD
    position: int = 0        # position at which next_token will be written

    @property
    def free(self) -> bool:
        return self.req is None


class DPGroup:
    def __init__(self, dp_id: int, backend: ExecutionBackend, *,
                 max_batch: int = 4, max_len: int = 256,
                 n_kv_blocks: int = 512, block_size: int = 16,
                 n_cache_blocks: Optional[int] = None,
                 gc_every: int = 200, pin_core: Optional[int] = None):
        self.dp_id = dp_id
        self.backend = backend
        self.max_batch = max_batch
        self.max_len = max_len
        self.tokenizer = ByteTokenizer()
        self.allocator = BlockAllocator(n_kv_blocks, block_size)
        # the radix prefix cache keeps hit statistics for TE routing
        # (its own block pool, so cached-but-unreferenced prefixes never
        # count against live requests in the kv_usage balancing of §4.3)
        self.prefix_cache = RadixTree(
            capacity_blocks=(n_kv_blocks if n_cache_blocks is None
                             else n_cache_blocks),
            block_size=block_size)
        self.gc_ctl = ProactiveGC(gc_every)
        pin_to_core(pin_core)

        self.slots = [Slot() for _ in range(max_batch)]
        self.cache = backend.init_cache(max_batch, max_len)
        # §4.6 MTP: the backend's draft depth; the group owns the batched
        # draft-head state beside the main cache (reset per slot at
        # admission)
        self.mtp_k = backend.mtp_k
        self.mtp_cache = (backend.init_mtp_cache(max_batch, max_len)
                          if self.mtp_k else None)
        self.steps = 0
        self.finished: List[Request] = []

        # admit-time sampling from prefill logits (host-side Gumbel draw)
        self._rng = np.random.default_rng(dp_id)
        # zero-sync fast path: in-flight (device tokens, [(slot, req)])
        self._pending: Optional[Tuple[Any, List[Tuple[int, Request]]]] \
            = None
        # EPLB swap deferred while a decode step is in flight
        self._pending_placement: Optional[Any] = None
        self._has_pending_placement = False

        # output shortcutting: dedicated worker streams detokenized output
        self._out_q: "queue.Queue" = queue.Queue()
        self._out_thread = threading.Thread(target=self._output_worker,
                                            daemon=True)
        self._out_thread.start()

        # token-recomputation rollback state (§6.2 stage 3)
        self._rollback: Optional[Dict[str, Any]] = None
        # chunked prefill: req_id → backend-opaque partial-prefill cache
        # (dropped when the final chunk completes or the request leaves)
        self._chunk_caches: Dict[int, PyTree] = {}

    # ------------------------------------------------------------------
    # output shortcutting worker
    # ------------------------------------------------------------------
    def _output_worker(self) -> None:
        while True:
            item = self._out_q.get()
            if item is None:
                return
            req, token = item
            req.emit(token)

    # ------------------------------------------------------------------
    # prefill path
    # ------------------------------------------------------------------
    def run_prefill_chunk(self, work) -> Optional[Tuple[PyTree,
                                                        np.ndarray]]:
        """Execute one :class:`~repro_torch.serving.scheduler.ChunkWork`
        via the backend's ``prefill_chunk`` contract. Blocks are
        allocated chunk-granularly — the request only holds blocks for
        tokens prefilled so far.

        Returns ``(batch-1 cache, last-position logits [V])`` once the
        prompt's prefill COMPLETES (final chunk); ``None`` while chunks
        are still outstanding."""
        req = work.req
        toks = req.prompt_tokens
        # context clipping: a prompt must leave room for generation inside
        # this DP's cache — keep the TAIL (engines clip at submit; this is
        # the safety net for direct callers)
        limit = max(self.max_len - req.max_new_tokens - 1, 16)
        if len(toks) > limit and work.is_first:
            toks = toks[-limit:]
            req.prompt_tokens = toks
            req.prefill_pos = min(req.prefill_pos, len(toks))
        if work.is_first:
            self.drop_partial_prefill(req)
        end = min(work.end, len(toks))
        self.allocator.extend(req.req_id, end)
        cache, logits = self.backend.prefill_chunk(
            self._chunk_caches.pop(req.req_id, None), toks[work.start:end],
            work.start, len(toks))
        if work.end >= len(toks):             # prompt complete
            self.prefix_cache.insert(toks)
            return cache, np.asarray(logits, np.float32)
        self._chunk_caches[req.req_id] = cache
        return None

    def drop_partial_prefill(self, req: Request) -> None:
        """Release a partially-prefilled request's chunk cache and
        chunk-granular block allocation (failover or cancellation)."""
        self._chunk_caches.pop(req.req_id, None)
        # an admitted request's blocks are freed by _finish instead
        if all(s.req is not req for s in self.slots):
            self.allocator.free(req.req_id, missing_ok=True)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def can_admit(self, req: Request) -> bool:
        has_slot = any(s.free for s in self.slots)
        # chunk-granular allocation means the request may already hold
        # blocks for its prefilled tokens — only the growth must fit
        need = req.prompt_len + req.max_new_tokens
        have = self.allocator.owned_tokens(req.req_id)
        return has_slot and (need <= have
                             or self.allocator.can_allocate(need - have))

    def admit(self, req: Request, cache1: PyTree,
              last_logits: np.ndarray) -> int:
        slot_id = next(i for i, s in enumerate(self.slots) if s.free)
        self.allocator.extend(req.req_id,
                              req.prompt_len + req.max_new_tokens)
        self.cache = self.backend.write_slot(self.cache, cache1, slot_id)
        if self.mtp_k:
            self.mtp_cache = self.backend.reset_mtp_slot(self.mtp_cache,
                                                         slot_id)
        first = self._sample(last_logits, req.temperature)
        req.n_emitted += 1
        self._out_q.put((req, int(first)))
        req.state = RequestState.DECODING
        req.slot = slot_id
        req.dp_group = self.dp_id
        self.slots[slot_id] = Slot(req=req, next_token=int(first),
                                   position=req.prompt_len)
        return slot_id

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _sample(self, logits: np.ndarray, temperature: float) -> int:
        if temperature <= 0.0:
            return int(np.argmax(logits))
        g = self._rng.gumbel(size=logits.shape)
        return int(np.argmax(logits / temperature + g))

    @property
    def active(self) -> int:
        return sum(0 if s.free else 1 for s in self.slots)

    def _gather_step_inputs(self):
        tokens = np.full((self.max_batch, 1), PAD, np.int32)
        positions = np.zeros((self.max_batch,), np.int32)
        temps = np.zeros((self.max_batch,), np.float32)
        active: List[Tuple[int, Request]] = []
        for i, s in enumerate(self.slots):
            if not s.free:
                tokens[i, 0] = s.next_token
                positions[i] = s.position
                temps[i] = s.req.temperature
                active.append((i, s.req))
        return tokens, positions, temps, active

    def _apply_sampled_mtp(self, blocks: np.ndarray, n_acc: np.ndarray,
                           active: List[Tuple[int, Request]]) -> int:
        """Host bookkeeping for one iteration: slot ``i`` emits
        ``blocks[i, :n_acc[i] + 1]`` in order (one token without MTP),
        each through the per-token done checks (EOS, budget, buffer
        edge): a stop in the middle of a block drops the rest of it and
        frees the slot, whose device-side junk the next admission
        resets."""
        produced = 0
        for i, req_at_launch in active:
            s = self.slots[i]
            if s.free or s.req is not req_at_launch:
                continue        # evicted/replaced between launch+complete
            req = s.req
            for j in range(int(n_acc[i]) + 1):
                tok = int(blocks[i, j])
                s.position += 1
                s.next_token = tok
                produced += 1
                req.n_emitted += 1
                done = (req.n_emitted >= req.max_new_tokens
                        or (tok == req.eos_token and not req.ignore_eos)
                        or s.position >= self.max_len - 1)
                self._out_q.put((req, tok))
                if done:
                    self._finish(i)
                    break
        self.steps += 1
        self.gc_ctl.step()
        return produced

    def decode_launch(self) -> bool:
        """Issue one decode iteration without waiting for its result.

        The backend's ``decode_sample`` (``decode_sample_mtp`` with MTP)
        queues its kernels on the device and returns its token tensors
        still on the device, so the caller can launch other DP groups /
        do host work while the device computes.
        """
        if self.active == 0 or self._pending is not None:
            return False
        tokens, positions, temps, active = self._gather_step_inputs()
        self._pending = (self._launch(tokens, positions, temps), active)
        return True

    def _launch(self, tokens, positions, temps, *, donate: bool = True):
        """One decode or MTP iteration on the backend; adopts the caches
        it returns and gives the device-side result."""
        if self.mtp_k:
            blocks, n_acc, self.cache, self.mtp_cache = \
                self.backend.decode_sample_mtp(
                    self.cache, self.mtp_cache, tokens, positions, temps,
                    self.steps, donate=donate)
            return blocks, n_acc
        toks, self.cache = self.backend.decode_sample(
            self.cache, tokens, positions, temps, self.steps, donate=donate)
        return toks

    def _apply(self, result, active) -> int:
        """Fetch a launched iteration's result (4·B bytes device→host;
        with MTP 4·B·(k+1) + 4·B) and run the bookkeeping."""
        if self.mtp_k:
            blocks, n_acc = (to_host(t) for t in result)
        else:                   # a block of one token per slot
            blocks = to_host(result)[:, None]
            n_acc = np.zeros(len(blocks), np.int32)
        return self._apply_sampled_mtp(blocks, n_acc, active)

    def decode_complete(self) -> int:
        """Fetch the launched iteration's tokens and run the host-side
        bookkeeping."""
        if self._pending is None:
            return 0
        result, active = self._pending
        self._pending = None
        produced = self._apply(result, active)
        if self._has_pending_placement:
            # deferred EPLB swap: the in-flight step has retired, so the
            # placement can change before the next launch (§4.5
            # reconfiguration never lands mid-iteration)
            table = self._pending_placement
            self._pending_placement = None
            self._has_pending_placement = False
            self.backend.apply_placement(table)
        return produced

    # ------------------------------------------------------------------
    # EPLB placement swap (§4.5 step 3, the "swap" phase)
    # ------------------------------------------------------------------
    def apply_placement(self, table: Optional[Any]) -> None:
        """Install a new expert placement on this group's backend. If a
        decode step is in flight, the swap is deferred to
        the ``decode_complete`` boundary (the reconfiguration contract:
        placement never changes mid-iteration)."""
        if self._pending is not None:
            self._pending_placement = table
            self._has_pending_placement = True
            return
        self.backend.apply_placement(table)

    def decode_step_all(self, inject_fault: bool = False) -> int:
        """One engine iteration over all active slots. Returns number of
        tokens produced. ``inject_fault`` exercises the §6.2 token-
        recomputation path: the step is rolled back and re-executed
        (with ``donate=False``, which keeps the pre-step cache intact)."""
        if self.active == 0:
            return 0
        if not inject_fault:
            self.decode_launch()
            return self.decode_complete()
        tokens, positions, temps, active = self._gather_step_inputs()
        # save rollback state (previous iteration boundary); donation is
        # off so the pre-step caches stay valid for re-execution. With
        # MTP the draft-head state rolls back beside the main cache: the
        # same step replays the same draws.
        self._rollback = {"cache": self.cache, "mtp_cache": self.mtp_cache,
                          "slots": [dataclasses.replace(s)
                                    for s in self.slots]}
        self._launch(tokens, positions, temps, donate=False)
        # §6.2: transient network error detected → all DP groups roll
        # back to the previous iteration and re-execute.
        self.cache = self._rollback["cache"]
        self.mtp_cache = self._rollback["mtp_cache"]
        self.slots = self._rollback["slots"]
        return self._apply(self._launch(tokens, positions, temps,
                                        donate=False), active)

    def _finish(self, slot_id: int) -> None:
        s = self.slots[slot_id]
        req = s.req
        self.allocator.free(req.req_id)
        req.t_finished = time.monotonic()
        req.state = RequestState.FINISHED
        self.finished.append(req)
        self.slots[slot_id] = Slot()

    # ------------------------------------------------------------------
    def status(self) -> DPStatus:
        return DPStatus(
            dp_id=self.dp_id,
            batch_size=self.max_batch,
            active=self.active,
            kv_usage=self.allocator.usage,
            kv_free_blocks=self.allocator.free_blocks,
            block_size=self.allocator.block_size,
        )

    def drain(self) -> None:
        while not self._out_q.empty():
            time.sleep(0.001)

    def close(self) -> None:
        self._out_q.put(None)
        self.gc_ctl.close()
