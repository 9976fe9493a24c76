"""Metric collection for the SuperPod simulator.

Virtual-time TTFT/TPOT per request, pod throughput, KV occupancy
timelines, and a sha256 event-trace digest used by the determinism
tests (same seed ⇒ byte-identical report JSON and trace hash).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ReqRecord:
    req_id: int
    arrival: float
    prompt_len: int
    max_new_tokens: int
    first_token: Optional[float] = None
    finish: Optional[float] = None
    n_tokens: int = 0
    n_failovers: int = 0

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        if self.finish is None or self.n_tokens < 2:
            return None
        return (self.finish - self.first_token) / (self.n_tokens - 1)


def _pct(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    return float(np.percentile(np.asarray(vals, np.float64), q))


@dataclasses.dataclass
class SimReport:
    summary: Dict
    per_request: List[Dict]
    kv_timeline: List[Tuple[float, float]]
    trace_hash: str

    def to_json(self, include_requests: bool = False) -> str:
        doc = {"summary": self.summary, "trace_hash": self.trace_hash}
        if include_requests:
            doc["per_request"] = self.per_request
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))


class MetricsCollector:
    def __init__(self, n_dies: int, die_scale: float = 1.0,
                 deployment: str = "colocated"):
        """``die_scale``: physical dies each simulated DP group stands
        for (>1 when the sim folds statistically-identical groups).
        ``deployment`` tags the report and enables the per-pool rows
        the ``moe_attn`` mode accumulates via :meth:`on_moe_attn_iter`."""
        self.n_dies = n_dies
        self.die_scale = die_scale
        self.deployment = deployment
        self.records: Dict[int, ReqRecord] = {}
        self.kv_samples: List[Tuple[float, float]] = []
        self.n_eplb_passes = 0
        self.n_reconfigs = 0          # completed placement swaps
        self.reconfig_bytes = 0       # expert weights migrated (fabric)
        self.reconfig_time_s = 0.0    # fabric time charged to migrations
        self.n_failovers = 0
        self.n_decode_iters = 0
        # §4.6 MTP observables. A slot-iteration is one active slot
        # going through one decode iteration; summing tokens over them
        # gives per-slot tokens/iteration (exactly 1.0 with MTP off,
        # 1 + E[accepted] with MTP on), and weighting each iteration's
        # priced duration by its active slots gives the per-request
        # effective TPOT: decode_slot_busy_s / n_decode_tokens.
        self.n_decode_tokens = 0
        self.n_slot_iters = 0
        self.decode_busy_s = 0.0       # Σ iteration durations
        self.decode_slot_busy_s = 0.0  # Σ duration · active slots
        # chunked prefill: chunks executed, decode iterations stretched
        # by a co-resident prefill chunk, and §7.2 long-context routing
        self.n_prefill_chunks = 0
        self.n_contended_decode_iters = 0
        self.n_long_prompts = 0
        self.n_long_routed_dedicated = 0
        # radix prefix cache: requests with a block-prefix hit, tokens
        # served from cache, chunk events the skip removed; KV-link FIFO:
        # transfers that queued behind an earlier one and total wait
        self.n_prefix_hits = 0
        self.n_prefix_hit_tokens = 0
        self.n_prefill_chunks_skipped = 0
        self.n_kv_xfers_queued = 0
        self.kv_link_wait_s = 0.0
        # pod-pooled prefix KV: requests seeded from ANOTHER TE's cached
        # prefix via the pod directory, tokens they skipped, and the UB
        # read time charged for pulling the owner's blocks
        self.n_pod_remote_hits = 0
        self.n_pod_remote_hit_tokens = 0
        self.n_remote_seed_reads = 0
        self.remote_seed_read_s = 0.0
        # two-SuperPod scale-out: KV transfers that crossed pods (priced
        # over the scale-out fabric — RoCE — instead of UB) and their
        # total wire time; pod-level failures and the requests they
        # rerouted to the surviving pod (zeros when n_pods == 1)
        self.n_cross_pod_kv_xfers = 0
        self.cross_pod_kv_s = 0.0
        self.n_pod_failovers = 0
        self.n_pod_reroutes = 0
        # moe_attn deployment: per-pool accounting over the MoE-layer
        # pipeline windows (seconds are virtual, per simulated DP; byte
        # counts are scaled to the whole pod by die_scale)
        self.pipeline_time_s = 0.0
        self.attn_busy_s = 0.0
        self.expert_busy_s = 0.0
        self.a2e_bytes = 0
        self.e2a_bytes = 0

    # ------------------------------------------------------------------
    def on_arrival(self, t: float, req) -> None:
        self.records[req.req_id] = ReqRecord(
            req.req_id, round(t, 9), req.prompt_len, req.max_new_tokens)

    def on_first_token(self, t: float, req) -> None:
        r = self.records[req.req_id]
        if r.first_token is None:
            r.first_token = round(t, 9)
        r.n_tokens += 1

    def on_token(self, t: float, req) -> None:
        self.records[req.req_id].n_tokens += 1
        self.n_decode_tokens += 1

    def on_finish(self, t: float, req) -> None:
        self.records[req.req_id].finish = round(t, 9)

    def on_failover(self, req) -> None:
        self.records[req.req_id].n_failovers += 1
        self.n_failovers += 1

    def sample_kv(self, t: float, usage: float) -> None:
        self.kv_samples.append((round(t, 9), round(usage, 6)))

    def on_moe_attn_iter(self, cost) -> None:
        """Accumulate one priced disaggregated iteration
        (:class:`~repro_torch.sim.fabric.MoEAttnIterCost`): pool busy time
        over the pipeline window and pod-scaled trampoline bytes."""
        self.pipeline_time_s += cost.t_pipeline
        self.attn_busy_s += cost.attn_busy_frac * cost.t_pipeline
        self.expert_busy_s += cost.expert_busy_frac * cost.t_pipeline
        self.a2e_bytes += int(cost.a2e_bytes * self.die_scale)
        self.e2a_bytes += int(cost.e2a_bytes * self.die_scale)

    # ------------------------------------------------------------------
    def report(self, t_end: float, trace: List[Tuple[float, str]],
               window: Optional[Tuple[float, float]] = None) -> SimReport:
        recs = list(self.records.values())
        done = [r for r in recs if r.finish is not None]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        tpots = [r.tpot for r in done if r.tpot is not None]
        total_tokens = sum(r.n_tokens for r in recs) * self.die_scale
        span = max(t_end, 1e-9)
        win_tpots = tpots
        if window is not None:
            lo, hi = window
            win_tpots = [r.tpot for r in done
                         if r.tpot is not None
                         and lo <= (r.first_token or 0.0) <= hi]

        h = hashlib.sha256()
        for t, name in trace:
            h.update(f"{t:.9f}:{name}\n".encode())

        summary = {
            "n_requests": len(recs),
            "n_finished": len(done),
            "total_tokens": int(total_tokens),
            "sim_duration_s": round(span, 9),
            "throughput_tok_s": round(total_tokens / span, 3),
            "throughput_tok_s_per_die": round(
                total_tokens / span / max(self.n_dies, 1), 3),
            "ttft_mean_s": round(float(np.mean(ttfts)) if ttfts else 0.0,
                                 6),
            "ttft_p99_s": round(_pct(ttfts, 99), 6),
            "tpot_mean_s": round(float(np.mean(tpots)) if tpots else 0.0,
                                 6),
            "tpot_p50_s": round(_pct(tpots, 50), 6),
            "tpot_p99_s": round(_pct(tpots, 99), 6),
            "tpot_window_mean_s": round(
                float(np.mean(win_tpots)) if win_tpots else 0.0, 6),
            "kv_peak_usage": round(
                max((u for _, u in self.kv_samples), default=0.0), 6),
            "kv_mean_usage": round(
                float(np.mean([u for _, u in self.kv_samples]))
                if self.kv_samples else 0.0, 6),
            "n_eplb_passes": self.n_eplb_passes,
            "n_reconfigs": self.n_reconfigs,
            "reconfig_bytes": int(self.reconfig_bytes),
            "reconfig_time_s": round(self.reconfig_time_s, 9),
            "n_failovers": self.n_failovers,
            "n_decode_iters": self.n_decode_iters,
            # §4.6 MTP observables (identities when MTP is off: exactly
            # 1 token per slot-iteration, effective TPOT == slot-weighted
            # mean iteration time)
            "n_decode_tokens": self.n_decode_tokens,
            "tokens_per_decode_iter": round(
                self.n_decode_tokens / max(self.n_slot_iters, 1), 6),
            "decode_busy_s": round(self.decode_busy_s, 9),
            "tpot_effective_s": round(
                self.decode_slot_busy_s / max(self.n_decode_tokens, 1),
                9),
            # chunked prefill + §7.2 long-context routing
            "n_prefill_chunks": self.n_prefill_chunks,
            "n_contended_decode_iters": self.n_contended_decode_iters,
            "n_long_prompts": self.n_long_prompts,
            "n_long_routed_dedicated": self.n_long_routed_dedicated,
            # radix prefix cache + KV-link contention
            "n_prefix_hits": self.n_prefix_hits,
            "n_prefix_hit_tokens": self.n_prefix_hit_tokens,
            "n_prefill_chunks_skipped": self.n_prefill_chunks_skipped,
            "n_kv_xfers_queued": self.n_kv_xfers_queued,
            "kv_link_wait_s": round(self.kv_link_wait_s, 9),
            # pod-pooled prefix KV (zeros when kv_pool is off)
            "n_pod_remote_hits": self.n_pod_remote_hits,
            "n_pod_remote_hit_tokens": self.n_pod_remote_hit_tokens,
            "n_remote_seed_reads": self.n_remote_seed_reads,
            "remote_seed_read_s": round(self.remote_seed_read_s, 9),
            # two-SuperPod scale-out (zeros when n_pods == 1)
            "n_cross_pod_kv_xfers": self.n_cross_pod_kv_xfers,
            "cross_pod_kv_s": round(self.cross_pod_kv_s, 9),
            "n_pod_failovers": self.n_pod_failovers,
            "n_pod_reroutes": self.n_pod_reroutes,
            # per-pool view (moe_attn deployment; zeros when colocated):
            # utilizations are busy fractions of the MoE-layer pipeline
            # windows, bubble is the expert pool's idle share — the
            # MegaScale-style cost of disaggregating at small batch
            "deployment": self.deployment,
            "attn_pool_util": round(
                self.attn_busy_s / self.pipeline_time_s
                if self.pipeline_time_s else 0.0, 6),
            "expert_pool_util": round(
                self.expert_busy_s / self.pipeline_time_s
                if self.pipeline_time_s else 0.0, 6),
            "pipeline_bubble_fraction": round(
                1.0 - self.expert_busy_s / self.pipeline_time_s
                if self.pipeline_time_s else 0.0, 6),
            "a2e_bytes": int(self.a2e_bytes),
            "e2a_bytes": int(self.e2a_bytes),
        }
        per_request = [
            {"req_id": r.req_id, "arrival": r.arrival,
             "prompt_len": r.prompt_len, "n_tokens": r.n_tokens,
             "ttft": round(r.ttft, 9) if r.ttft is not None else None,
             "tpot": round(r.tpot, 9) if r.tpot is not None else None,
             "failovers": r.n_failovers}
            for r in sorted(recs, key=lambda r: r.req_id)]
        return SimReport(summary, per_request, self.kv_samples,
                         h.hexdigest())
