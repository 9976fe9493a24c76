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

Prefill consults the radix prefix cache: when the backend supports the
prefix-KV contract (``supports_prefix_kv``), a prompt's full KV blocks
are stored as payloads on completion, and a later prompt that shares a
block prefix is seeded from them so only its suffix runs (a chunk the
cache covers entirely is skipped). With a
:class:`~repro_torch.serving.kv_cache.PodKVDirectory` the group publishes
its blocks pod-wide and, on a longer hit elsewhere, pins the owner's
blocks and reads them through ``read_remote_kv``; the pin is released
exactly once, on completion or on any cancel path.
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
from repro_torch.serving.kv_cache import (BlockAllocator, PodKVDirectory,
                                          RadixTree, RemotePin)
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
                 gc_every: int = 200, pin_core: Optional[int] = None,
                 pod_directory: Optional[PodKVDirectory] = None):
        self.dp_id = dp_id
        self.backend = backend
        self.max_batch = max_batch
        self.max_len = max_len
        self.tokenizer = ByteTokenizer()
        self.allocator = BlockAllocator(n_kv_blocks, block_size)
        # the radix prefix cache pages its stored KV out of its OWN block
        # pool, so cached-but-unreferenced KV never counts against live
        # requests in the kv_usage balancing of §4.3
        self.prefix_cache = RadixTree(
            capacity_blocks=(n_kv_blocks if n_cache_blocks is None
                             else n_cache_blocks),
            block_size=block_size)
        # payload storage and seeding only when the backend can slice KV
        # and resume mid-prompt; otherwise the tree keeps hit statistics
        self._prefix_kv = bool(backend.supports_prefix_kv
                               and backend.supports_chunked_prefill)
        # pod-pooled prefix KV: publish this group's cached blocks and
        # seed from other groups' blocks on a longer remote hit
        self.pod_dir = pod_directory if self._prefix_kv else None
        if self.pod_dir is not None:
            self.pod_dir.register(dp_id, self.prefix_cache)
        self.n_remote_hits = 0
        self.remote_hit_blocks = 0
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
        # req_id → locked radix path while the request seeds from it
        self._chunk_locks: Dict[int, List[Any]] = {}
        # req_id → remote pin on another group's blocks while this
        # request seeds from them (released exactly once, through
        # _unlock_chunk, on completion or cancellation)
        self._chunk_pins: Dict[int, RemotePin] = {}

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
    def _cache_insert(self, toks: List[int], cache: PyTree) -> None:
        """Store the prompt's full KV blocks in the radix cache (the
        slicer runs only for blocks not cached yet); without prefix-KV
        support the tree keeps hit statistics only."""
        if self._prefix_kv:
            self.prefix_cache.insert(
                toks,
                lambda s, e: self.backend.slice_prefill_kv(
                    cache, toks, s, e))
        else:
            self.prefix_cache.insert(toks)

    def _clip(self, req: Request) -> List[int]:
        """Context clipping: a prompt must leave room for generation
        inside this group's cache, so keep its TAIL (engines clip at
        submit; this is the safety net for direct callers)."""
        toks = req.prompt_tokens
        limit = max(self.max_len - req.max_new_tokens - 1, 16)
        if len(toks) > limit:
            toks = toks[-limit:]
            req.prompt_tokens = toks
            req.prefill_pos = min(req.prefill_pos, len(toks))
        return toks

    def run_prefill(self, req: Request) -> Tuple[PyTree, np.ndarray]:
        """Prefill a whole prompt. Returns ``(batch-1 cache,
        last-position logits [V])``.

        A radix-cache hit (local, or a longer one elsewhere in the pod)
        seeds a fresh prefill cache from the stored block payloads and
        runs only the suffix through ``prefill_chunk`` (the match is
        capped below the prompt length, so a real forward always gives
        the last token's logits)."""
        toks = self._clip(req)
        m = self.prefix_cache.match_blocks(toks) if self._prefix_kv \
            else None
        local = m.n_tokens if (m is not None and m.n_blocks > 0
                               and m.has_payloads) else 0
        pin = self._acquire_remote(toks, local)
        if pin is not None:
            try:
                payloads = self.backend.read_remote_kv(pin.payloads)
                seeded = self.backend.seed_prefill_cache(
                    payloads, pin.n_tokens, len(toks))
                cache, logits = self.backend.prefill_chunk(
                    seeded, toks[pin.n_tokens:], pin.n_tokens, len(toks))
            finally:
                self.pod_dir.release(pin)
            req.prefix_hit_tokens = max(req.prefix_hit_tokens,
                                        pin.n_tokens)
        elif local > 0:
            self.prefix_cache.lock(m.nodes)
            try:
                seeded = self.backend.seed_prefill_cache(
                    m.payloads, m.n_tokens, len(toks))
                cache, logits = self.backend.prefill_chunk(
                    seeded, toks[m.n_tokens:], m.n_tokens, len(toks))
            finally:
                self.prefix_cache.unlock(m.nodes)
            req.prefix_hit_tokens = max(req.prefix_hit_tokens, m.n_tokens)
        else:
            cache, logits = self.backend.prefill(toks)
        logits = np.asarray(logits, np.float32)
        self._cache_insert(toks, cache)
        return cache, logits

    def _seed_first_chunk(self, req: Request, toks: List[int],
                          work) -> Optional[int]:
        """On a request's first chunk, seed its partial cache from the
        best cached prefix: a remote pin when it covers more than the
        local hit, else the local path (locked). Returns the position
        the chunk resumes at, or None when the cache covers the whole
        chunk: it is skipped and ``prefill_pos`` jumps past the seed."""
        m = self.prefix_cache.match_blocks(toks)
        local = m.n_tokens if (m.n_blocks > 0 and m.has_payloads) else 0
        pin = self._acquire_remote(toks, local)
        if pin is not None:
            # the pin stays held until the prefill completes or is
            # dropped: both release it through _unlock_chunk
            self._chunk_pins[req.req_id] = pin
            payloads = self.backend.read_remote_kv(pin.payloads)
            n = pin.n_tokens
        elif local > 0:
            self.prefix_cache.lock(m.nodes)
            self._chunk_locks[req.req_id] = m.nodes
            payloads, n = m.payloads, m.n_tokens
        else:
            return work.start
        self._chunk_caches[req.req_id] = self.backend.seed_prefill_cache(
            payloads, n, len(toks))
        req.prefix_hit_tokens = n
        self.allocator.extend(req.req_id, n)
        if n >= work.end:
            req.prefill_pos = max(req.prefill_pos, n)
            return None
        return n

    def run_prefill_chunk(self, work) -> Optional[Tuple[PyTree,
                                                        np.ndarray]]:
        """Execute one :class:`~repro_torch.serving.scheduler.ChunkWork`
        via the backend's ``prefill_chunk`` contract.

        On the FIRST chunk the radix cache (and the pod directory) is
        consulted: a matched block prefix seeds the partial cache from
        stored KV, advances ``req.prefill_pos`` past fully cached chunks
        (the scheduler then emits only suffix chunks) and stays locked
        or pinned until the prefill completes or is dropped. Blocks are
        allocated chunk-granularly — the request only holds blocks for
        tokens prefilled so far.

        Returns ``(batch-1 cache, last-position logits [V])`` once the
        prompt's prefill COMPLETES (final chunk); ``None`` while chunks
        are still outstanding or when this chunk was skipped entirely
        off a cache hit."""
        req = work.req
        toks = self._clip(req) if work.is_first else req.prompt_tokens
        start = work.start
        if work.is_first:
            self.drop_partial_prefill(req)
            if self._prefix_kv:
                start = self._seed_first_chunk(req, toks, work)
                if start is None:
                    return None
        end = min(work.end, len(toks))
        self.allocator.extend(req.req_id, end)
        cache, logits = self.backend.prefill_chunk(
            self._chunk_caches.pop(req.req_id, None), toks[start:end],
            start, len(toks))
        if work.end >= len(toks):             # prompt complete
            logits = np.asarray(logits, np.float32)
            self._unlock_chunk(req)
            self._cache_insert(toks, cache)
            return cache, logits
        self._chunk_caches[req.req_id] = cache
        return None

    def partial_prefill_cache(self, req: Request) -> Optional[PyTree]:
        """The partial-prefill cache of an in-flight chunked request
        (None once complete or absent): disaggregated PD slices finished
        chunks out of it to stream KV while later chunks compute."""
        return self._chunk_caches.get(req.req_id)

    def _acquire_remote(self, toks: List[int],
                        local_tokens: int) -> Optional[RemotePin]:
        """Pin the best pod-directory prefix STRICTLY longer than the
        local hit (a remote read is worth its traffic only when it skips
        compute a local seed would not). Returns a held pin, whose
        exactly-once release the caller owns, or None."""
        if self.pod_dir is None:
            return None
        owner, n_blocks = self.pod_dir.match(toks, exclude=self.dp_id)
        if owner is None or \
                n_blocks * self.prefix_cache.block_size <= local_tokens:
            return None
        pin = self.pod_dir.acquire(owner, toks)
        if pin is None:
            return None
        if pin.n_tokens <= local_tokens or not pin.has_payloads:
            self.pod_dir.release(pin)
            return None
        self.n_remote_hits += 1
        self.remote_hit_blocks += pin.n_blocks
        return pin

    @property
    def pooled_hit_rate(self) -> float:
        """Cache hit rate INCLUDING pod-directory remote hits: the stat
        TE routing reads, so a group warm through the pod is not
        counted cold (local only: ``prefix_cache.hit_rate``)."""
        c = self.prefix_cache
        return min((c.hit_blocks + self.remote_hit_blocks)
                   / max(c.query_blocks, 1), 1.0)

    def _unlock_chunk(self, req: Request) -> None:
        nodes = self._chunk_locks.pop(req.req_id, None)
        if nodes:
            self.prefix_cache.unlock(nodes)
        pin = self._chunk_pins.pop(req.req_id, None)
        if pin is not None:
            self.pod_dir.release(pin)

    def drop_partial_prefill(self, req: Request) -> None:
        """Release a partially-prefilled request's chunk cache, radix
        locks, remote pin and chunk-granular block allocation (failover
        or cancellation)."""
        self._chunk_caches.pop(req.req_id, None)
        self._unlock_chunk(req)
        # chunk-granular blocks of an unfinished prefill go back to the
        # pool (an admitted request's blocks are freed by _finish)
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

    def active_requests(self) -> List[Request]:
        return [s.req for s in self.slots if not s.free]

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

    def evict(self, slot_id: int) -> Optional[Request]:
        """Pull a request out of a slot without finishing it (dead-DP
        failover, §6.2: the caller re-dispatches it elsewhere): its
        blocks go back to the allocator and it is queued again."""
        s = self.slots[slot_id]
        if s.free:
            return None
        req = s.req
        self.allocator.free(req.req_id)
        self.slots[slot_id] = Slot()
        req.state = RequestState.QUEUED
        req.slot = None
        req.dp_group = None
        return req

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
        # join the output worker: a daemon thread still emitting while
        # the interpreter exits aborts the process
        self._out_q.put(None)
        self._out_thread.join()
        self.gc_ctl.close()
