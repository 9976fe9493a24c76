"""TE-shell (§4.2): the deliberately-thin central orchestrator.

Exactly three responsibilities: dispatching requests across DP groups
(via the §4.3 load balancers — decode placement AND the chunk-granular
prefill schedule), triggering expert load balancing, and coordinating
health checks. Scheduling of admitted work, output handling, caching and
networking are fully decentralized in the DP groups.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.dp_group import DPGroup
from repro_torch.serving.eplb import (ExpertLoadCollector, PlacementTable,
                                build_expert_map, build_placement_table,
                                ExpertMap)
from repro_torch.serving.reliability import (Clock, HeartbeatPeer,
                                       TieredHeartbeat)
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import (ChunkWork, DecodeLoadBalancer,
                                     DPStatus, PrefillScheduler)


class TEShell:
    def __init__(self, dp_groups: Sequence[DPGroup],
                 n_layers: int = 1, n_experts: int = 0,
                 eplb_budget: int = 2, clock: Optional[Clock] = None,
                 dp_peers: Optional[Sequence[HeartbeatPeer]] = None,
                 balancer: Optional[DecodeLoadBalancer] = None,
                 eplb_max_slices: int = 64,
                 prefill_scheduler: Optional[PrefillScheduler] = None,
                 pod_of_dp: Optional[Sequence[int]] = None):
        self.dps = list(dp_groups)
        # pod-level failure domains (two-SuperPod scale-out): which
        # SuperPod each DP group lives in. A whole-pod failure
        # (fail_pod) drains every DP in the pod at once — the balancer
        # stops routing there and schedule_prefill_chunks requeues its
        # partially-prefilled requests onto the surviving pod's DPs.
        self.pod_of_dp = (list(pod_of_dp) if pod_of_dp is not None
                          else [0] * len(self.dps))
        if len(self.pod_of_dp) != len(self.dps):
            raise ValueError(
                f"pod_of_dp has {len(self.pod_of_dp)} entries for "
                f"{len(self.dps)} DP groups")
        self.balancer = balancer or DecodeLoadBalancer()
        # chunk-granular prefill schedule (§4.3): the shell owns the
        # shared queue; schedule_prefill_chunks assigns token-budget
        # ChunkWork slices across the DP groups each engine step
        self.prefill_sched = prefill_scheduler or PrefillScheduler(
            n_dps=len(self.dps))
        self.n_experts = n_experts
        self.collector = (ExpertLoadCollector(n_layers, n_experts,
                                              max_slices=eplb_max_slices)
                          if n_experts else None)
        self.eplb_budget = eplb_budget
        self.expert_maps: Dict[int, ExpertMap] = {}
        self.clock = clock or Clock()
        # peers are injectable so deployments (and the SuperPod simulator)
        # can wire real liveness probes into the tiered heartbeat; names
        # must stay "dp<id>" — health_tick parses them back.
        peers = (list(dp_peers) if dp_peers is not None
                 else [HeartbeatPeer(f"dp{d.dp_id}") for d in self.dps])
        self.heartbeat = TieredHeartbeat(self.clock, peers)
        self.dispatched = 0

    # -- responsibility 1: request dispatch --------------------------------
    def dispatch(self, req: Request) -> Optional[int]:
        # statuses() folds in health-check results so a DP the heartbeat
        # declared dead stops receiving traffic immediately
        dp_id = self.balancer.pick(self.statuses(), req)
        if dp_id is not None:
            self.dispatched += 1
        return dp_id

    def submit_prefill(self, req: Request) -> None:
        """Queue a tokenized request for chunk-granular prefill."""
        self.prefill_sched.submit(req)

    def schedule_prefill_chunks(self) -> List[List[ChunkWork]]:
        """One leader scheduling pass: per-DP ChunkWork batches under
        the token budget, continuing partially-prefilled requests first.
        New requests are only admitted onto healthy DPs that currently
        have a decode slot + KV headroom for them (the colocated engine
        decodes where it prefilled). Requests pinned to a DP the
        heartbeat has since declared unhealthy are requeued with their
        cursor reset — the partial KV there is lost — and their chunk
        caches released."""
        statuses = {s.dp_id: s for s in self.statuses()}
        for idx, d in enumerate(self.dps):
            if not statuses[d.dp_id].healthy:
                for req in self.prefill_sched.requeue_dp(idx):
                    d.drop_partial_prefill(req)

        def can_admit(dp_idx: int, req: Request) -> bool:
            s = statuses[self.dps[dp_idx].dp_id]
            return s.healthy and self.dps[dp_idx].can_admit(req)

        def hit_rate(req: Request) -> float:
            # Pod-pooled prefix KV: a prefix cached on ANOTHER TE's DP is
            # still a hit for admission ordering — the owner's blocks are
            # UB-readable, so the request skips the same prefill work.
            # The pod directory's view is a superset of the local one, so
            # a plain max folds remote coverage in without double count.
            local = max(d.prefix_cache.match_fraction(req.prompt_tokens)
                        for d in self.dps)
            pods = {d.pod_dir for d in self.dps
                    if getattr(d, "pod_dir", None) is not None}
            remote = max(
                (p.match_fraction(req.prompt_tokens) for p in pods),
                default=0.0)
            return max(local, remote)

        return self.prefill_sched.schedule_step(
            hit_rate_fn=hit_rate, can_admit_fn=can_admit)

    # -- responsibility 2: EPLB trigger -------------------------------------
    def record_expert_counts(self, counts: np.ndarray) -> None:
        if self.collector is not None:
            self.collector.record(counts)

    def plan_eplb(self, n_npus: int, slots_per_npu: int = 1)\
            -> Dict[int, ExpertMap]:
        """Compute fresh per-layer maps from collected loads WITHOUT
        activating them — the phased reconfiguration (prefetch →
        shadow-load → swap) decides when they go live."""
        if self.collector is None:
            return {}
        self.collector.end_slice()
        tc = self.collector.token_count          # [L, E, T]
        return {layer: build_expert_map(tc[layer], self.n_experts,
                                        self.eplb_budget, n_npus,
                                        slots_per_npu)
                for layer in range(tc.shape[0])}

    def trigger_eplb(self, n_npus: int, slots_per_npu: int = 1)\
            -> Dict[int, ExpertMap]:
        """Periodic (e.g. per-minute) EPLB pass over collected loads:
        plan + immediate activation (deployments that price the phased
        migration use :meth:`plan_eplb` + :meth:`activate_maps`)."""
        maps = self.plan_eplb(n_npus, slots_per_npu)
        if maps:
            self.expert_maps = maps
        return self.expert_maps

    def activate_maps(self, maps: Dict[int, ExpertMap],
                      push_to_dps: bool = True) -> Optional[PlacementTable]:
        """The swap phase: make ``maps`` the active placement and (by
        default) install the stacked :class:`PlacementTable` on every DP
        group's backend — each group defers to its next decode-iteration
        boundary (see ``DPGroup.apply_placement``)."""
        self.expert_maps = dict(maps)
        table = self.placement_table()
        if push_to_dps:
            # table may be None (no layer has redundancy): push anyway
            # so backends revert from a previously active placement
            for d in self.dps:
                d.apply_placement(table)
        return table

    def placement_table(self) -> Optional[PlacementTable]:
        """Stack the active per-layer maps into one placement table.
        Shapes are padded to the redundancy budget so successive EPLB
        passes keep the same kernel shapes.

        Returns ``None`` when NO layer carries a redundant replica: an
        all-identity table would make the forward path pay the
        owner-gather of expert weights for nothing, so the backends are
        reverted to plain logical routing instead."""
        if not self.expert_maps or self.collector is None:
            return None
        maps = [self.expert_maps.get(layer)
                for layer in range(self.collector.n_layers)]
        if not any(m is not None and m.enabled
                   and any(len(s) > 1 for s in m.replicas.values())
                   for m in maps):
            return None
        return build_placement_table(
            maps, self.n_experts,
            pad_physical=self.n_experts + self.eplb_budget,
            pad_replicas=1 + self.eplb_budget)

    # -- responsibility 3: health checks -------------------------------------
    def health_tick(self) -> List[str]:
        res = self.heartbeat.tick()
        failed = res["dp"]
        for name in failed:
            dp_id = int(name[2:])
            # reflected in status() → balancer stops routing there
            for d in self.dps:
                if d.dp_id == dp_id:
                    d._healthy = False
        return failed

    def fail_pod(self, pod_id: int) -> List[str]:
        """Declare a whole pod's failure domain down (§6 / P/D-Serve
        pod granularity): every DP group in ``pod_id`` is marked
        unhealthy and its heartbeat peer dead, so the decode balancer
        and the chunk scheduler drain it immediately instead of waiting
        out per-DP heartbeat timeouts. Returns the failed DP names
        (``dp<id>``), mirroring :meth:`health_tick`."""
        failed = []
        for d, pod in zip(self.dps, self.pod_of_dp):
            if pod == pod_id and getattr(d, "_healthy", True):
                d._healthy = False
                failed.append(f"dp{d.dp_id}")
        names = set(failed)
        for p in self.heartbeat.l2.peers:
            if p.name in names:
                p.alive = False
        return failed

    def dead_pods(self) -> List[int]:
        """Pods whose EVERY DP group is unhealthy — the failure domains
        cross-pod rerouting keys on (a pod with one live DP still
        serves; a fully-dead pod's traffic must leave the pod)."""
        alive_pods = set()
        all_pods = set()
        for d, pod in zip(self.dps, self.pod_of_dp):
            all_pods.add(pod)
            if getattr(d, "_healthy", True):
                alive_pods.add(pod)
        return sorted(all_pods - alive_pods)

    def statuses(self) -> List[DPStatus]:
        out = []
        for d in self.dps:
            s = d.status()
            s.healthy = getattr(d, "_healthy", True)
            out.append(s)
        return out
