"""Disaggregated Prefill-Decode (§5.1).

Separate prefill and decode TEs, each a FlowServe engine with its own
mesh/sharding regime (prefill: TP-heavy, eager bucketed shapes; decode:
EP+DP, static graph), connected by DistFlow over XCCL. The workflow
implements the paper's 8 steps:

 1. JE picks a prefill TE (cache status + load + length-aware).
 2. Prefill TE schedules the request onto one of its DP groups.
 3. On completion, the DP master registers a PD-transfer task (metadata
    only) with its DistFlow instance.
 4. JE dispatches to a decode TE by real-time load.
 5. Decode TE routes to a DP group (KV-usage-aware).
 6. The decode DP checks KV capacity; insufficient → deferred RECV
    (backpressure); sufficient → async RECV submitted.
 7. DistFlow moves/reshards the KV (fabric-dependent: UB within the
    SuperPod, RoCE/VPC for heterogeneous 910B prefill).
 8. Completion queues: prefill frees blocks, decode enqueues the request.

Chunked prefill changes the granularity of steps 2-7: the prefill
scheduler emits token-budget CHUNKS (continuing partially-prefilled
requests first), the decode TE is picked at the FIRST chunk, and each
finished chunk's KV layers stream to it immediately
(``DistFlowInstance.stream_chunk``) so the wire time of all but the
final chunk hides under subsequent chunks' compute — instead of one
post-hoc bulk copy after the whole prompt. Backends without incremental
prefill (``supports_chunked_prefill == False``) keep the bulk path.

One :class:`~repro_torch.models.transformer.Model` and one parameter set
serve every TE's DP groups, each through its own
:class:`~repro_torch.serving.backend.TorchBackend` on ``device`` (the
card unless the caller asks for the CPU). With ``kv_pool`` one
:class:`~repro_torch.serving.kv_cache.PodKVDirectory` spans every prefill
DP group, so a session re-landing on another TE seeds from the pod.

``ctx`` (as the reference's ``DisaggregatedPD(ctx=)``) serves on a mesh:
both sides share it and the one model on it, one process per rank, each
running this workflow on the same requests (``rules`` and the layout of
given ``params`` as ``FlowServeEngine(ctx=)``). Prefill TEs keep chunk
buffers, whose KV is the same global tensors on every rank, so the
transfers hand it off in place, and each decode TE's ``write_slot``
cuts its rank's block of the slots.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serving.backend import TorchBackend
from repro_torch.serving.distflow import DistFlowInstance
from repro_torch.serving.dp_group import DPGroup
from repro_torch.serving.kv_cache import PodKVDirectory
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import (DecodeLoadBalancer,
                                           PrefillScheduler,
                                           pick_prefill_te)
from repro_torch.serving.tokenizer import ByteTokenizer
from repro_torch.xccl.pd_transfer import slice_kv_chunk
from repro_torch.xccl.topology import PodTopology

PyTree = Any

# Routing-time cost share of a pod-pooled UB read relative to the
# prefill compute it replaces (the reference simulator's
# 1 - prefix_remote_seed).
REMOTE_SEED_COST = 0.15


@dataclasses.dataclass
class PrefillTE:
    """A prefill task executor: DP groups running bucketed prefill only."""
    te_id: int
    dps: List[DPGroup]
    scheduler: PrefillScheduler
    long_capable: bool = False
    fabric: str = "ub"            # "roce"/"vpc" when running on 910B

    def stats(self) -> Dict:
        return {
            "te_id": self.te_id,
            "load": len(self.scheduler.queue),
            # real radix-cache hit rate (lifetime fraction of queried
            # blocks served from cache, INCLUDING pod-directory remote
            # hits — a TE warm through the pooled cache must not score
            # as cold) — feeds the hit-fraction-aware TE routing of
            # pick_prefill_te
            "cache_hit": float(np.mean([
                d.pooled_hit_rate for d in self.dps])
                if self.dps else 0.0),
            "mean_len": 512,
            "long": self.long_capable,
        }


@dataclasses.dataclass
class DecodeTE:
    te_id: int
    dps: List[DPGroup]
    balancer: DecodeLoadBalancer


class DisaggregatedPD:
    """M prefill TEs × N decode TEs with full-mesh DistFlow connectivity."""

    @staticmethod
    def _pod_list(pods: Optional[Sequence[int]], n: int,
                  name: str) -> List[int]:
        if pods is None:
            return [0] * n
        out = [int(p) for p in pods]
        if len(out) != n:
            raise ValueError(f"{name} has {len(out)} entries for {n} TEs")
        return out

    def __init__(self, cfg: ModelConfig, params: Optional[PyTree] = None,
                 *, n_prefill_te: int = 2, n_decode_te: int = 1,
                 dp_per_te: int = 2, max_batch: int = 2,
                 max_len: int = 256, device="cuda", ctx=None, rules=None,
                 prefill_fabrics: Optional[Sequence[str]] = None,
                 seed: int = 0, token_budget: int = 8192,
                 chunk_tokens: Optional[int] = None, mtp_k: int = 0,
                 kv_pool: bool = False,
                 topology: Optional["PodTopology"] = None,
                 pod_of_prefill_te: Optional[Sequence[int]] = None,
                 pod_of_decode_te: Optional[Sequence[int]] = None):
        """``topology`` replaces the flat ``prefill_fabrics`` list: with
        a :class:`~repro_torch.xccl.topology.PodTopology` plus per-TE pod
        placements, each (prefill TE, decode TE) DistFlow pair gets the
        fabric of ITS pod pair — intra-pod UB, cross-pod RoCE — instead
        of one fabric per prefill TE regardless of destination (the
        §7.2 heterogeneous two-pod shape needs per-pair selection: a
        910B prefill TE reaches its own pod's decode over UB but the
        910C pod over RoCE). Pod placements default to pod 0; passing
        both ``topology`` and ``prefill_fabrics`` is an error."""
        self.cfg = cfg
        self.max_len = max_len
        if topology is not None and prefill_fabrics is not None:
            raise ValueError(
                "pass either topology (per-pair fabric from pod "
                "placement) or prefill_fabrics (flat per-TE list), "
                "not both")
        self.topology = topology
        self._prefill_pod = self._pod_list(
            pod_of_prefill_te, n_prefill_te, "pod_of_prefill_te")
        self._decode_pod = self._pod_list(
            pod_of_decode_te, n_decode_te, "pod_of_decode_te")
        self.device = resolve_device(device)
        self.model = Model(cfg, ctx=ctx, rules=rules)
        self.params = (params if params is not None
                       else self.model.init(seed, device=self.device))
        self.tokenizer = ByteTokenizer()

        # pod-pooled prefix KV (kv_pool): one directory spans every
        # prefill DP across ALL prefill TEs, so a session re-landing on
        # another TE seeds over UB instead of re-prefilling
        self.pod_dir = PodKVDirectory() if kv_pool else None
        if topology is not None:
            # the TE-level fabric (routing heuristics, stats) is the
            # link toward the FIRST decode TE's pod; each DistFlow pair
            # below still gets its own per-pair link
            d0 = self._decode_pod[0] if self._decode_pod else 0
            fabrics = [topology.link(p, d0) for p in self._prefill_pod]
        else:
            fabrics = list(prefill_fabrics or ["ub"] * n_prefill_te)
        self.prefill_tes = [
            PrefillTE(
                te_id=i,
                dps=[DPGroup(100 * i + j,
                             TorchBackend(self.model, self.params,
                                          max_len=max_len,
                                          device=self.device),
                             max_batch=max_batch, max_len=max_len,
                             pod_directory=self.pod_dir)
                     for j in range(dp_per_te)],
                scheduler=PrefillScheduler(dp_per_te,
                                           token_budget=token_budget,
                                           chunk_tokens=chunk_tokens),
                long_capable=(i == 0),
                fabric=fabrics[i])
            for i in range(n_prefill_te)
        ]
        # MTP runs only on the decode side: prefill TEs never decode, so
        # their backends stay draft-free; decode TEs own the draft-head
        # state and emit variable tokens-per-iteration through the same
        # streaming watermark (n_emitted-based, so multi-token steps
        # stream correctly without changes here)
        self.decode_tes = [
            DecodeTE(
                te_id=i,
                dps=[DPGroup(1000 + 100 * i + j,
                             TorchBackend(self.model, self.params,
                                          max_len=max_len, mtp_k=mtp_k,
                                          device=self.device),
                             max_batch=max_batch, max_len=max_len)
                     for j in range(dp_per_te)],
                balancer=DecodeLoadBalancer())
            for i in range(n_decode_te)
        ]
        # isolated DistFlow instance per (prefill TE, decode TE) pair;
        # with a topology, the pair's fabric comes from its pod pair
        # (step 7: UB within a SuperPod, RoCE across pods)
        self.distflow: Dict[str, DistFlowInstance] = {}
        for p in self.prefill_tes:
            for d in self.decode_tes:
                key = f"p{p.te_id}-d{d.te_id}"
                if self.topology is not None:
                    fab = self.topology.link(
                        self._prefill_pod[p.te_id],
                        self._decode_pod[d.te_id])
                else:
                    fab = p.fabric
                self.distflow[key] = DistFlowInstance(key, fabric=fab)

        self._pending_admit: List[Dict] = []
        # per-request KV-stream watermark: tokens shipped to decode so
        # far (radix chunk-skips make shipped ranges diverge from
        # ChunkWork boundaries — the seeded prefix is never executed but
        # must still reach the decode TE)
        self._shipped: Dict[int, int] = {}
        self.finished: List[Request] = []

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.prompt_tokens is None:
            req.prompt_tokens = self.tokenizer.encode(req.prompt)
        # context-clip up front so chunk boundaries see the final prompt
        limit = max(self.max_len - req.max_new_tokens - 1, 16)
        if req.prompt_len > limit:
            req.prompt_tokens = req.prompt_tokens[-limit:]
        # step 1: JE → prefill TE (cache-aware when the pod directory is
        # on: weigh this request's local hit vs best cross-TE remote hit,
        # the latter discounted by the UB read's cost share)
        pod_match = None
        if self.pod_dir is not None:
            def pod_match(te_id: int, r: Request,
                          tes=self.prefill_tes):
                te = tes[te_id]
                local = max(d.prefix_cache.match_fraction(r.prompt_tokens)
                            for d in te.dps)
                remote = self.pod_dir.match_fraction(
                    r.prompt_tokens,
                    exclude={d.dp_id for d in te.dps})
                return local, remote
        te_id = pick_prefill_te([t.stats() for t in self.prefill_tes], req,
                                pod_match_fn=pod_match,
                                remote_seed_cost=REMOTE_SEED_COST)
        req.prefill_te = te_id
        req.state = RequestState.PREFILLING
        self.prefill_tes[te_id].scheduler.submit(req)

    # ------------------------------------------------------------------
    def _run_chunk(self, te: PrefillTE, dp: DPGroup, work) -> None:
        """Steps 2-7 at chunk granularity: execute one chunk, stream its
        KV layers to the (first-chunk-pinned) decode TE while the next
        chunk computes, and queue admission on the final chunk."""
        req = work.req
        done = dp.run_prefill_chunk(work)                  # step 2
        if req.decode_te is None:
            dte = self._pick_decode_te(req)                # step 4, early
            req.decode_te = dte.te_id
        dte = self.decode_tes[req.decode_te]
        flow = self.distflow[f"p{te.te_id}-d{dte.te_id}"]
        streaming = dp.backend.supports_chunked_prefill
        end = min(work.end, req.prompt_len)
        if streaming:
            if req.req_id not in flow.streams:
                flow.open_stream(req.req_id,
                                 {"prompt_len": req.prompt_len})
            lo = self._shipped.get(req.req_id, 0)
            if done is None:
                # step 3/7 chunk-wise: ship every valid-but-unshipped
                # position now — the wire time hides under the next
                # chunk's compute (async SEND on the MTE/SDMA engines).
                # The valid watermark is the executed end OR the radix-
                # seeded prefix (prefill_pos after a chunk-skip),
                # whichever is further.
                hi = max(end, min(req.prefill_pos, req.prompt_len))
                if hi > lo:
                    flow.stream_chunk(
                        req.req_id,
                        slice_kv_chunk(dp.partial_prefill_cache(req),
                                       lo, hi))
                    self._shipped[req.req_id] = hi
                return
            cache1, logits = done
            # final slice: stream whatever earlier chunks have not
            # shipped yet (from 0 when the prompt completed in one go)
            self._shipped.pop(req.req_id, None)
            flow.stream_chunk(req.req_id,
                              slice_kv_chunk(cache1, lo,
                                             req.prompt_len),
                              last=True)
            req.state = RequestState.TRANSFERRING
            self._pending_admit.append(
                {"req": req, "flow": flow, "te": dte, "logits": logits,
                 "stream": True})
            return
        if done is None:
            return                 # buffering fallback: nothing to ship
        cache1, logits = done
        # legacy bulk path: one deferred, pull-triggered transfer
        task = flow.register(req.req_id, cache1,
                             {"logits": logits,
                              "prompt_len": req.prompt_len})
        req.state = RequestState.TRANSFERRING
        self._pending_admit.append(
            {"req": req, "flow": flow, "task": task.task_id,
             "te": dte, "logits": logits, "stream": False})

    def step(self) -> int:
        produced = 0
        # ---- prefill TEs: chunk-granular collaborative scheduling -------
        for te in self.prefill_tes:
            batches = te.scheduler.schedule_step(
                hit_rate_fn=lambda r, te=te: max(
                    d.prefix_cache.match_fraction(r.prompt_tokens)
                    for d in te.dps))
            for dp, works in zip(te.dps, batches):
                for work in works:
                    self._run_chunk(te, dp, work)
        # ---- decode side: admit under backpressure ----------------------
        still: List[Dict] = []
        for item in self._pending_admit:
            req, flow, dte = item["req"], item["flow"], item["te"]
            dp_id = dte.balancer.pick([d.status() for d in dte.dps], req)
            dp = (None if dp_id is None
                  else next(d for d in dte.dps if d.dp_id == dp_id))
            if item["stream"]:
                # stream already landed chunk by chunk; only admission
                # capacity gates here (step 6 backpressure)
                if dp is None or not dp.can_admit(req):
                    still.append(item)
                    continue
                kv = flow.pop_stream(req.req_id)
                assert kv is not None, "stream must be complete"
                dp.admit(req, kv, item["logits"])
                continue
            # step 6: capacity check (backpressure when absent)
            if dp is None or not dp.can_admit(req):
                flow.trigger(item["task"], lambda: False)
                still.append(item)
                continue
            ok = flow.trigger(item["task"], lambda: True)  # step 7
            assert ok
            for task in flow.poll_completions():           # step 8
                if task.req_id == req.req_id:
                    dp.admit(req, task.result, item["logits"])
        self._pending_admit = still
        # ---- decode TEs: continuous batching ----------------------------
        for dte in self.decode_tes:
            for dp in dte.dps:
                produced += dp.decode_step_all()
                for r in dp.finished:
                    self.finished.append(r)
                dp.finished = []
        return produced

    def _pick_decode_te(self, req: Request) -> DecodeTE:
        loads = [(sum(d.active for d in t.dps), i)
                 for i, t in enumerate(self.decode_tes)]
        return self.decode_tes[min(loads)[1]]

    # ------------------------------------------------------------------
    def run_until_done(self, reqs: Sequence[Request],
                       max_steps: int = 10_000) -> List[Request]:
        for r in reqs:
            self.submit(r)
        steps = 0
        while len(self.finished) < len(reqs):
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"stalled: {len(self.finished)}/{len(reqs)} done")
        for te in self.decode_tes:
            for d in te.dps:
                d.drain()
        return list(self.finished)

    def close(self) -> None:
        for te in self.prefill_tes:
            for d in te.dps:
                d.close()
        for te in self.decode_tes:
            for d in te.dps:
                d.close()
