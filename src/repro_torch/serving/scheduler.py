"""DP load balancing (§4.3): prefill collaborative scheduler + decode
KV-usage balancer.

Prefill: single-level collaborative scheduling over CHUNKS. All tokenized
requests sit in ONE shared queue; a leader (DP-0's scheduler) assembles
per-DP batches each step using a cost model (prefix-cache hit rate, batch
token budget, length-aware anti-straggler grouping). This replaces the
two-level design the paper found straggler-prone.

The unit of work is a :class:`ChunkWork` — a contiguous token-budget
slice of one prompt — not a whole prompt. Each ``schedule_step``:

1. CONTINUES partially-prefilled requests first: a request whose earlier
   chunks ran on DP *d* stays pinned to *d* (its partial KV cache lives
   there) and gets its next chunk before any new request is admitted.
2. ADMITS new requests from the shared queue with their FIRST chunk,
   using the existing cost model (cache-hit priority, length buckets,
   round-robin within buckets) under the remaining per-DP token budget.

A prompt no longer than ``chunk_tokens`` (default: the token budget)
degenerates to exactly one chunk — the pre-chunking behavior.

Decode: exclude DP groups at their batch limit; among the rest pick the
lowest KV-cache usage, accounting for reserved space for long outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.request import Request


@dataclasses.dataclass
class DPStatus:
    """Per-DP metrics the TE-shell tracks (§4.3): updated on dispatch and
    completion; KV stats collected periodically."""
    dp_id: int
    batch_size: int              # max concurrent decode slots
    active: int = 0              # running requests
    pending: int = 0             # dispatched but not yet running
    kv_usage: float = 0.0        # fraction of KV blocks in use
    kv_free_blocks: int = 0
    block_size: int = 16
    healthy: bool = True

    @property
    def full(self) -> bool:
        return self.active + self.pending >= self.batch_size


# ---------------------------------------------------------------------------
# Prefill: single-level collaborative scheduler over chunks
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ChunkWork:
    """One schedulable unit of prefill: a contiguous token slice
    ``[start, start + n_tokens)`` of ``req``'s prompt, to be executed via
    the backend's ``prefill_chunk`` contract on the DP it was assigned
    to. Emitted by :meth:`PrefillScheduler.schedule_step`; the emitting
    step advances ``req.prefill_pos`` past this chunk, so chunks of one
    request are contiguous by construction."""
    req: Request
    start: int
    n_tokens: int

    @property
    def end(self) -> int:
        return self.start + self.n_tokens

    @property
    def is_first(self) -> bool:
        return self.start == 0

    @property
    def is_last(self) -> bool:
        return self.end >= self.req.prompt_len


class PrefillScheduler:
    def __init__(self, n_dps: int, token_budget: int = 8192,
                 length_bucket: float = 2.0,
                 chunk_tokens: Optional[int] = None):
        self.n_dps = n_dps
        self.token_budget = token_budget      # per DP per step
        self.length_bucket = length_bucket
        # chunk granularity: a prompt is sliced into ceil(len / chunk)
        # chunks. Defaults to the token budget, so budget-sized prompts
        # degenerate to the old one-chunk-per-prompt behavior.
        self.chunk_tokens = (chunk_tokens if chunk_tokens
                             else token_budget)
        self.queue: List[Request] = []
        # partially-prefilled requests, pinned to the DP holding their
        # partial KV cache (index = DP slot)
        self.inflight: List[List[Request]] = [[] for _ in range(n_dps)]

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @property
    def pending(self) -> int:
        """Requests with unscheduled prefill work (queued + in flight)."""
        return len(self.queue) + sum(
            1 for dp in self.inflight for r in dp
            if r.prefill_remaining > 0)

    def requeue_dp(self, dp: int) -> List[Request]:
        """Pull a DP's partially-prefilled requests back into the shared
        queue with their chunk cursors reset: the partial KV on that DP
        is gone (dead/unhealthy DP), so prefill restarts from token 0
        wherever the next step places it (§6.2 failover). Returns the
        moved requests so the caller can release their partial caches."""
        moved = self.inflight[dp]
        self.inflight[dp] = []
        for r in moved:
            r.prefill_pos = 0
            self.queue.append(r)
        return moved

    def _emit(self, batches: List[List[ChunkWork]],
              budgets: List[int], dp: int, req: Request) -> ChunkWork:
        n = min(self.chunk_tokens, req.prefill_remaining, budgets[dp])
        work = ChunkWork(req, req.prefill_pos, n)
        req.prefill_pos += n
        req.n_prefill_chunks += 1
        batches[dp].append(work)
        budgets[dp] -= n
        return work

    def schedule_step(self, hit_rate_fn=None,
                      can_admit_fn: Optional[Callable[[int, Request],
                                                      bool]] = None
                      ) -> List[List[ChunkWork]]:
        """Leader step (all-gathered DP status → global assignment).

        Returns per-DP batches of :class:`ChunkWork`. Partially-
        prefilled requests are continued first (one chunk per request
        per step, pinned to their DP); the remaining budget then admits
        new requests by the cost model: sort by (cache-hit desc, length
        asc); fill DPs round-robin within LENGTH BUCKETS so one DP
        doesn't draw a short batch while another draws a long one (the
        straggler mode §4.3 calls out). ``can_admit_fn(dp, req)`` may
        veto placing a NEW request's first chunk on a DP (e.g. no free
        decode slot downstream).

        The caller must execute (or account) the returned chunks before
        the next ``schedule_step`` — emission advances each request's
        ``prefill_pos`` cursor.
        """
        batches: List[List[ChunkWork]] = [[] for _ in range(self.n_dps)]
        budgets = [self.token_budget] * self.n_dps
        # 1) continue in-flight requests before admitting new ones
        for dp in range(self.n_dps):
            still: List[Request] = []
            for r in self.inflight[dp]:
                if r.prefill_remaining <= 0:
                    continue                  # done (or prefix-cache hit)
                if budgets[dp] > 0:
                    self._emit(batches, budgets, dp, r)
                if r.prefill_remaining > 0:
                    still.append(r)
            self.inflight[dp] = still
        if not self.queue:
            return batches
        # 2) admit new requests with their first chunk
        hit = hit_rate_fn or (lambda r: 0.0)
        self.queue.sort(key=lambda r: (-hit(r), r.prompt_len))
        remaining: List[Request] = []
        # bucket by length so co-scheduled batches are homogeneous
        buckets: Dict[int, List[Request]] = {}
        for r in self.queue:
            b = 0
            n = max(r.prompt_len, 1)
            while n > 128:
                n /= self.length_bucket
                b += 1
            buckets.setdefault(b, []).append(r)
        dp = 0
        for b in sorted(buckets):
            for r in buckets[b]:
                # a chunk never exceeds the per-step budget, so even
                # prompts longer than the budget admit (the pre-chunking
                # scheduler starved them — they could never fit whole)
                first = min(self.chunk_tokens, max(r.prompt_len, 1),
                            self.token_budget)
                placed = False
                for off in range(self.n_dps):
                    cand = (dp + off) % self.n_dps
                    if budgets[cand] < first:
                        continue
                    if (can_admit_fn is not None
                            and not can_admit_fn(cand, r)):
                        continue
                    self._emit(batches, budgets, cand, r)
                    if r.prefill_remaining > 0:
                        self.inflight[cand].append(r)
                    dp = (cand + 1) % self.n_dps
                    placed = True
                    break
                if not placed:
                    remaining.append(r)
        self.queue = remaining
        return batches


# ---------------------------------------------------------------------------
# Decode: KV-usage-aware placement
# ---------------------------------------------------------------------------
class DecodeLoadBalancer:
    def __init__(self, reserve_tokens: int = 256):
        self.reserve_tokens = reserve_tokens

    def pick(self, statuses: Sequence[DPStatus],
             req: Request) -> Optional[int]:
        """Exclude full/unhealthy groups; among the rest pick lowest KV
        usage with room for prompt + reserved output space."""
        best: Optional[DPStatus] = None
        for s in statuses:
            if not s.healthy or s.full:
                continue
            need_blocks = -(-(req.prompt_len + self.reserve_tokens)
                            // s.block_size)
            if s.kv_free_blocks < need_blocks:
                continue
            if best is None or s.kv_usage < best.kv_usage:
                best = s
        return None if best is None else best.dp_id


# ---------------------------------------------------------------------------
# JE-level prefill TE selection (§5.1 step 1)
# ---------------------------------------------------------------------------
def pick_prefill_te(tes: Sequence[Dict], req: Request,
                    long_threshold: int = 8192,
                    pod_match_fn: Optional[
                        Callable[[int, Request], Tuple[float, float]]]
                    = None,
                    remote_seed_cost: float = 0.0) -> int:
    """cache status + system load + request length. Long requests go to
    TEs marked long-capable (dedicated long-sequence resources, §7.2);
    TEs marked ``long_only`` form a DEDICATED long-context pool — short
    requests never land there, so long-prompt prefill chunks cannot
    interfere with the pod's short-request serving (§7.2).

    With a pod-pooled prefix cache, routing becomes cache-aware per
    request: ``pod_match_fn(te_id, req)`` returns this request's
    ``(local_hit_fraction, remote_hit_fraction)`` were it routed to that
    TE — the fraction of the prompt the TE's own radix trees hold vs the
    best prefix OTHER TEs publish in the pod directory. A local hit
    skips compute outright; a remote hit skips the same compute minus
    the UB read, discounted by ``remote_seed_cost`` (the fraction of the
    skipped compute the read costs back, ``1 - prefix_remote_seed`` in
    cost-model terms). Weighing both against plain recompute means a
    session re-landing anywhere near its history still scores the warm
    TE highest, but a locally-cold TE with pod coverage beats a fully
    cold one instead of tying with it."""
    scored: List[Tuple[float, int]] = []
    is_long = req.prompt_len > long_threshold
    for te in tes:
        if is_long and not te.get("long", False):
            continue
        if not is_long and te.get("long_only", False):
            continue
        score = (2.0 * te.get("cache_hit", 0.0)
                 - te.get("load", 0.0)
                 - 0.2 * abs(te.get("mean_len", 512) - req.prompt_len)
                 / max(req.prompt_len, 1))
        if pod_match_fn is not None:
            local, remote = pod_match_fn(te["te_id"], req)
            discount = max(1.0 - remote_seed_cost, 0.0)
            score += 2.0 * max(local, remote * discount)
        scored.append((score, te["te_id"]))
    if not scored:
        scored = [(-te.get("load", 0.0), te["te_id"]) for te in tes]
    return max(scored)[1]
