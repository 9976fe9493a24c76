"""SuperPod simulator engine.

Runs the REAL serving control plane — ``PrefillScheduler`` batching,
``pick_prefill_te`` TE selection, ``TEShell``/``DecodeLoadBalancer``
decode dispatch, ``ExpertLoadCollector`` + ``build_expert_map`` EPLB,
tiered heartbeats and dead-DP failover — over simulated DP groups whose
execution backend is the roofline/XCCL cost model. The partition comes
from the real ``plan_partition`` (DeepSeek-V3 on 768 dies ⇒ the paper's
288-expert/480-attention split in 3 DP domains).

Folding: simulating 480 one-die DP groups one event at a time is wasted
work when they are statistically identical, so ``n_sim_dps`` groups each
stand for ``n_attention / n_sim_dps`` physical dies; the cost model
prices iterations per-die so latencies are unaffected, and throughput is
scaled back up by ``die_scale``. Faults target individual sim groups.
Each simulated ``DPGroup`` runs an output-worker thread: ``run`` joins
them all when it ends (also when the loop raises), ``close`` does so for
a sim that is never run, and a constructor that raises after building
them joins them before it re-raises.

Two deployments share this event loop (``SimConfig.deployment``): the
colocated decode plan prices each DP group's iteration as the serial
§4.4 layer chain on its own die, while ``"moe_attn"`` (§5.2) prices it
through the DP-domain pipeline over a SEPARATE shared expert pool —
stage times from the same cost model, composed by the
``DomainPipeline`` closed form that ``DomainPipeline.schedule()``
cross-validates, with A2E/E2A trampoline latency on every microbatch
chain and pool-aware fault injection (an expert-pool fault degrades
every attention DP that dispatches to it).

EPLB is simulated PER LAYER: ``n_sim_expert_layers`` representative MoE
layers (each standing for ``n_moe_layers / L`` physical layers) collect
independent routing counts, get independent maps from
``TEShell.plan_eplb``, and price the decode iteration layer by layer —
a hot expert in layer 5 lengthens exactly layer 5's share of the
iteration. Reconfiguration is phased (§4.5: prefetch → shadow-load →
swap) through :class:`~repro_torch.serving.eplb.ExpertReconfigurator`: new
maps only take routing effect after the migration's weight traffic has
been paid on the UB fabric, each DP group's next iteration is charged
the migration's fabric contention, and the swap lands on every
simulated backend through the ``apply_placement`` contract.

PREFILL is chunk-granular on the main event loop: each TE's
``PrefillScheduler`` emits token-budget :class:`ChunkWork` slices
(continuing partially-prefilled prompts first), every chunk is its own
event priced by ``prefill_chunk_time`` (late chunks of long prompts cost
more — the attention term grows with context), and each finished chunk's
KV streams to the decode side overlapped with the next chunk's compute,
so only the FINAL chunk's wire time gates admission (TTFT). With
``prefill_colocated=True`` the (non-dedicated) prefill streams share
dies with decode DP groups and a decode iteration that overlaps a
prefill chunk stretches by the cost model's contention factor; the §7.2
``long_context_tes`` knob carves dedicated long-prompt TEs that route
``> long_context_threshold`` prompts away from the shared dies, removing
that interference for everyone else.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.transformerless import plan_partition
from repro_torch.serving.dp_group import DPGroup
from repro_torch.serving.eplb import (ExpertReconfigurator,
                                      ReconfigState)
from repro_torch.serving.kv_cache import (PodKVDirectory, RadixTree,
                                          RemotePin)
from repro_torch.serving.reliability import HeartbeatPeer
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import (ChunkWork, PrefillScheduler,
                                           pick_prefill_te)
from repro_torch.serving.te_shell import TEShell
from repro_torch.sim.events import EventLoop
from repro_torch.sim.fabric import (CostModelBackend, DieModel,
                                    FabricModel, SuperPodCostModel)
from repro_torch.xccl.topology import CHIP_CLASSES, PodSpec, PodTopology
from repro_torch.sim.metrics import MetricsCollector, SimReport
from repro_torch.sim.workload import WorkloadConfig, WorkloadGen

MAX_IMBALANCE = 64.0


@dataclasses.dataclass
class FaultPlan:
    """Scenario injection. Times are virtual seconds.

    ``straggler_pool`` / ``dead_pool`` select which resource pool the
    die index addresses: ``"attention"`` targets a simulated decode DP
    group (both deployments), ``"expert"`` targets one of the
    ``moe_attn`` deployment's shared expert-pool dies — every attention
    DP dispatches to every expert die, so an expert-pool fault degrades
    the whole pod's MoE stage rather than one DP group."""
    straggler_dp: Optional[int] = None
    straggler_at: float = 1.0
    straggler_slowdown: float = 3.0
    straggler_pool: str = "attention"
    dead_dp: Optional[int] = None
    dead_at: float = 1.5
    dead_pool: str = "attention"
    expert_skew: float = 0.0          # Zipf exponent of expert popularity
    # pod-level failure domain (two-SuperPod deployments): at
    # ``dead_pod_at`` every prefill TE in ``dead_pod_id`` dies at once —
    # its queued and in-flight prefill work is drained and rerouted to
    # the surviving pod(s) with chunk cursors reset (the partial KV is
    # lost, §6.2 recompute). The decode pod cannot be the target.
    dead_pod_id: Optional[int] = None
    dead_pod_at: float = 1.5


@dataclasses.dataclass
class SimConfig:
    arch: str = "deepseek-v3-671b"
    total_dies: int = 768             # CloudMatrix384: 384 chips × 2 dies
    n_sim_dps: int = 16               # simulated decode DP groups
    # §5 deployment mapping — which Transformerless composition the
    # decode event loop prices:
    #
    # * ``"colocated"`` (§5.1 baseline / PD-colocated decode): every DP
    #   group's die runs the whole layer serially — attention, then the
    #   EP dispatch/MoE/combine — so one iteration is the §4.4
    #   ping-pong layer chain of ``SuperPodCostModel.decode_iter_time``
    #   and a die fault touches exactly one DP group.
    # * ``"moe_attn"`` (§5.2 MoE-Attention disaggregation): attention
    #   and expert halves live on separate NPU pools bridged by the
    #   §3.3 A2E/E2A trampolines. DP groups model ATTENTION-pool dies;
    #   a shared expert pool (folded to ``n_sim_expert_dies`` sim dies)
    #   serves all DP domains through the Fig. 19 pipeline
    #   (``moe_attn_decode_iter_time``), EPLB per-layer maps price the
    #   expert stage, reconfig weight traffic lands on the expert
    #   pool's UB links, and expert-pool faults degrade every
    #   attention DP that dispatches to the pool.
    deployment: str = "colocated"
    # folded expert-pool dies simulated in the moe_attn deployment
    # (each stands for plan.n_expert / n_sim_expert_dies physical dies)
    n_sim_expert_dies: int = 8
    max_batch: int = 96               # decode slots per die (paper bpd)
    max_len: int = 8192
    n_kv_blocks: int = 8192
    eplb_enabled: bool = True
    # per-layer EPLB: independent maps for every simulated MoE layer;
    # False replays the layer-0-only policy (one map for all layers)
    eplb_per_layer: bool = True
    # representative MoE layers the sim collects/balances (each stands
    # for n_moe_layers / L physical layers; folding like n_sim_dps)
    n_sim_expert_layers: int = 8
    eplb_interval_s: float = 1.0
    # optional measured-benchmark JSONs (BENCH_*.json) — when set, the
    # cost model is built with SuperPodCostModel.from_calibration
    calibration_paths: Optional[Tuple[str, ...]] = None
    heartbeat_interval_s: float = 0.2
    kv_sample_interval_s: float = 0.1
    schedule_interval_s: float = 0.02
    admit_retry_s: float = 0.02
    n_prefill_tes: int = 2
    prefill_streams_per_te: int = 4
    prefill_dies_per_stream: int = 16
    # chunked prefill: token-budget slice size and per-stream per-step
    # budget of the chunk scheduler (chunk == budget ⇒ budget-sized
    # prompts degenerate to one chunk)
    prefill_chunk_tokens: int = 2048
    prefill_token_budget: int = 8192
    # radix prefix directory per prefill TE (block capacity of the
    # accounting tree): arriving prompts match against what the TE has
    # already prefilled, fully-cached chunks are skipped (fewer chunk
    # events), and the residual seed cost is priced by the cost model's
    # ``prefill_hit_skip`` (calibratable ``prefill/hit_skip`` row)
    te_prefix_cache_blocks: int = 8192
    # per-link FIFO for the prefill→decode KV path: each TE multiplexes
    # its streams' ChunkStream transfers over n_kv_links_per_te UB
    # links; overlapping transfers on one link queue behind each other.
    # Default False preserves the legacy uncontended transfer model
    # (and byte-identical traces for existing seeds).
    kv_link_fifo: bool = False
    n_kv_links_per_te: int = 1
    # pod-pooled prefix KV over UB global shared memory: one
    # PodKVDirectory spans every prefill TE's radix directory, so a
    # prompt that misses locally but matches another TE's cached prefix
    # seeds from it instead of recomputing — charged as a UB read
    # through the KV link FIFOs plus the un-saved compute residue
    # (cost model ``prefix_remote_seed``, calibratable via the
    # ``prefix/remote_seed`` row). Default False preserves existing
    # seeds byte-identically.
    kv_pool: bool = False
    # overrides the cost model's remote-seed save fraction (None keeps
    # the default / calibrated ``prefix/remote_seed`` value)
    kv_pool_remote_seed: Optional[float] = None
    # PD-colocated interference: map (non-dedicated) prefill streams
    # onto decode DP dies — a decode iteration overlapping a prefill
    # chunk on its die stretches by the cost model's contention factor.
    # Only meaningful for deployment="colocated".
    prefill_colocated: bool = False
    # §7.2 dedicated long-context pools: the first N prefill TEs serve
    # ONLY prompts above long_context_threshold (and are never mapped
    # onto decode dies). 0 keeps the legacy "TE 0 is long-capable too"
    # topology.
    long_context_tes: int = 0
    long_context_threshold: int = 8192
    # §4.6 MTP speculative decoding: draft tokens per decode iteration
    # (0 = off, byte-identical to the pre-MTP build per seed). When on,
    # decode iterations run through the decode_sample_mtp contract —
    # variable tokens-per-step with per-iteration accepted lengths drawn
    # from the cost model's calibratable acceptance distribution — and
    # decode_iter_time prices the draft+verify work. Colocated
    # deployment only (the moe_attn pipeline is not MTP-priced yet).
    mtp_k: int = 0
    # overrides the cost model's per-draft acceptance probability
    # (None keeps the default / calibrated ``mtp/acceptance`` value)
    mtp_acceptance: Optional[float] = None
    # §4.5 placement data plane: True (default) prices decode through
    # the gather-free owner-indexed GMM (placement-active iterations add
    # nothing unless an ``eplb/placement_gmm`` calibration row says so);
    # False prices the legacy owner-gathered weight materialization on
    # every placement-active step (pure HBM traffic per MoE layer).
    placement_gather_free: bool = True
    # -- two-SuperPod scale-out (§7.2 / P/D-Serve shape) ----------------
    # number of SuperPods. 1 (default) is the single-pod deployment,
    # byte-identical to the pre-pod build per seed. With n_pods > 1 the
    # sim builds a PodTopology: intra-pod traffic stays on UB, any
    # cross-pod path (prefill TE in one pod streaming KV to the decode
    # pod in another, or a pod-pooled remote seed read across pods)
    # prices over the scale-out fabric through the same kv-link FIFOs.
    n_pods: int = 1
    # pod of each prefill TE (len n_prefill_tes; entries < n_pods).
    # None ⇒ round-robin across pods, so a two-pod run has both local
    # and remote prefill capacity by default.
    pod_of_te: Optional[Tuple[int, ...]] = None
    # pod hosting the decode DP groups (the 910C pod in the
    # heterogeneous shape); KV from prefill TEs in other pods crosses
    # the scale-out fabric
    decode_pod: int = 0
    # per-pod chip class ("910C"/"910B"): prefill chunks on a 910B-class
    # pod run at that class's compute_scale (§7.2 prior-gen prefill
    # pods). None ⇒ decode pod 910C, every other pod 910B.
    pod_classes: Optional[Tuple[str, ...]] = None
    # scale-out link between pods
    cross_pod_fabric: str = "roce"
    drain_timeout_s: float = 120.0
    seed: int = 0


class _PrefillTE:
    """Simulated prefill TE: a chunk scheduler over ``n_streams``
    execution streams, each a serial FIFO of :class:`ChunkWork` events
    on the main loop (the fluid busy-until model this replaces could not
    express chunk-level KV overlap or decode interference)."""

    def __init__(self, te_id: int, n_streams: int, long_capable: bool,
                 long_only: bool = False, token_budget: int = 8192,
                 chunk_tokens: Optional[int] = None,
                 prefix_cache_blocks: int = 8192, pod: int = 0):
        self.te_id = te_id
        self.pod = pod
        # cleared by a pod-level failure: a dead TE stops scheduling,
        # drops in-flight chunk completions, and is skipped by routing
        self.alive = True
        self.scheduler = PrefillScheduler(n_dps=n_streams,
                                          token_budget=token_budget,
                                          chunk_tokens=chunk_tokens)
        self.queues: List[Deque[ChunkWork]] = \
            [deque() for _ in range(n_streams)]
        self.busy = [False] * n_streams
        # the chunk each busy stream is executing right now — what a
        # pod failure must recover in addition to the scheduler's state
        self.inflight: List[Optional[ChunkWork]] = [None] * n_streams
        self.long_capable = long_capable
        self.long_only = long_only
        self.mean_len = 512.0
        # accounting-only radix directory of prompts this TE has
        # prefilled (stands for the KV its DP dies hold); arriving
        # prompts match their block prefix here and skip cached chunks
        self.prefix_dir = RadixTree(capacity_blocks=prefix_cache_blocks)
        # EWMA of per-request hit fraction: the pick_prefill_te routing
        # signal (stays exactly 0.0 while no request ever hits)
        self.hit_ewma = 0.0

    def stats(self, now: float) -> Dict:
        backlog = sum(len(q) for q in self.queues) + sum(self.busy)
        return {"te_id": self.te_id,
                "load": len(self.scheduler.queue) + backlog,
                "cache_hit": self.hit_ewma,
                "mean_len": self.mean_len,
                "long": self.long_capable,
                "long_only": self.long_only}


class SuperPodSim:
    def __init__(self, sim_cfg: SimConfig,
                 wl_cfg: Optional[WorkloadConfig] = None,
                 faults: Optional[FaultPlan] = None):
        self.cfg = sim_cfg
        self.faults = faults or FaultPlan()
        self.model_cfg = get_config(sim_cfg.arch)
        self.plan = plan_partition(self.model_cfg, sim_cfg.total_dies)
        if sim_cfg.deployment not in ("colocated", "moe_attn"):
            raise ValueError(f"unknown deployment {sim_cfg.deployment!r}")
        if sim_cfg.deployment == "moe_attn" and (
                not self.model_cfg.has_moe or self.plan.n_expert <= 0):
            raise ValueError(
                "deployment='moe_attn' needs a MoE model with expert dies")
        if sim_cfg.prefill_colocated and sim_cfg.deployment != "colocated":
            raise ValueError(
                "prefill_colocated shares prefill streams with decode "
                "dies — only the colocated deployment has them on one "
                "die")
        if not 0 <= sim_cfg.long_context_tes < sim_cfg.n_prefill_tes:
            raise ValueError(
                f"long_context_tes={sim_cfg.long_context_tes} must leave "
                f"at least one general TE of {sim_cfg.n_prefill_tes}")
        if sim_cfg.mtp_k < 0:
            raise ValueError(f"mtp_k={sim_cfg.mtp_k} must be >= 0")
        if sim_cfg.mtp_k > 0 and sim_cfg.deployment != "colocated":
            raise ValueError(
                "mtp_k > 0 is priced through decode_iter_time — only the "
                "colocated deployment supports MTP in the sim")
        # -- pod layout (two-SuperPod scale-out) -------------------------
        if sim_cfg.n_pods < 1:
            raise ValueError(f"n_pods={sim_cfg.n_pods} must be >= 1")
        if not 0 <= sim_cfg.decode_pod < sim_cfg.n_pods:
            raise ValueError(
                f"decode_pod={sim_cfg.decode_pod} out of range "
                f"(n_pods={sim_cfg.n_pods})")
        if sim_cfg.pod_of_te is None:
            self._te_pod = [i % sim_cfg.n_pods
                            for i in range(sim_cfg.n_prefill_tes)]
        else:
            self._te_pod = [int(p) for p in sim_cfg.pod_of_te]
            if len(self._te_pod) != sim_cfg.n_prefill_tes:
                raise ValueError(
                    f"pod_of_te has {len(self._te_pod)} entries for "
                    f"{sim_cfg.n_prefill_tes} prefill TEs")
            if any(not 0 <= p < sim_cfg.n_pods for p in self._te_pod):
                raise ValueError(
                    f"pod_of_te={self._te_pod} has entries outside "
                    f"[0, {sim_cfg.n_pods})")
        if sim_cfg.pod_classes is None:
            pod_classes = ["910C" if p == sim_cfg.decode_pod else "910B"
                           for p in range(sim_cfg.n_pods)]
        else:
            pod_classes = [str(c) for c in sim_cfg.pod_classes]
            if len(pod_classes) != sim_cfg.n_pods:
                raise ValueError(
                    f"pod_classes has {len(pod_classes)} entries for "
                    f"{sim_cfg.n_pods} pods")
            for c in pod_classes:
                if c not in CHIP_CLASSES:
                    raise ValueError(f"unknown chip class {c!r}")
        self.topology = (PodTopology(
            pods=tuple(PodSpec(chip_class=c) for c in pod_classes),
            cross_fabric=sim_cfg.cross_pod_fabric)
            if sim_cfg.n_pods > 1 else None)
        # 910B-class pods run prefill chunks slower by 1/compute_scale
        self._pod_slowdown = [
            1.0 / self.topology.compute_scale(p) if self.topology else 1.0
            for p in range(sim_cfg.n_pods)]
        if self.faults.dead_pod_id is not None:
            dead = self.faults.dead_pod_id
            if sim_cfg.n_pods < 2:
                raise ValueError("dead_pod_id needs n_pods >= 2")
            if not 0 <= dead < sim_cfg.n_pods:
                raise ValueError(
                    f"dead_pod_id={dead} out of range "
                    f"(n_pods={sim_cfg.n_pods})")
            if dead == sim_cfg.decode_pod:
                raise ValueError(
                    "dead_pod_id cannot target the decode pod — the "
                    "decode DP pool has no surviving pod to fail over to")
            if all(p == dead for p in self._te_pod):
                raise ValueError(
                    "dead_pod_id would kill every prefill TE; at least "
                    "one TE must live in a surviving pod")
        for kind, pool, idx in (
                ("straggler", self.faults.straggler_pool,
                 self.faults.straggler_dp),
                ("dead", self.faults.dead_pool, self.faults.dead_dp)):
            if pool not in ("attention", "expert"):
                raise ValueError(f"unknown fault pool {pool!r}")
            if idx is None:
                continue
            if pool == "expert" and sim_cfg.deployment != "moe_attn":
                raise ValueError(
                    "expert-pool faults need deployment='moe_attn' — the "
                    "colocated plan has no separate expert pool to target")
            n_pool = (sim_cfg.n_sim_expert_dies if pool == "expert"
                      else sim_cfg.n_sim_dps)
            if not 0 <= idx < n_pool:
                raise ValueError(
                    f"{kind} fault targets {pool} die {idx}, but the sim "
                    f"folds that pool to {n_pool} dies")
        fabric = FabricModel(topology=self.topology)
        if sim_cfg.calibration_paths:
            self.cost = SuperPodCostModel.from_calibration(
                self.model_cfg, self.plan,
                list(sim_cfg.calibration_paths), fabric)
        else:
            self.cost = SuperPodCostModel(self.model_cfg, self.plan,
                                          fabric)
        if sim_cfg.mtp_acceptance is not None:
            self.cost.mtp_acceptance = float(
                np.clip(sim_cfg.mtp_acceptance, 0.0, 1.0))
        self.cost.placement_gather_free = bool(
            sim_cfg.placement_gather_free)
        if sim_cfg.kv_pool_remote_seed is not None:
            self.cost.prefix_remote_seed = float(
                np.clip(sim_cfg.kv_pool_remote_seed, 0.0, 1.0))
        self.loop = EventLoop()

        wl = wl_cfg or WorkloadConfig()
        if self.faults.expert_skew > 0 and wl.expert_skew == 0:
            wl = dataclasses.replace(wl,
                                     expert_skew=self.faults.expert_skew)
        n_experts = (self.model_cfg.moe.num_experts
                     if self.model_cfg.has_moe else 0)
        # folded per-layer EPLB view: L representative MoE layers
        self.n_layers_sim = (max(1, min(sim_cfg.n_sim_expert_layers,
                                        self.cost.n_moe_layers))
                             if n_experts else 1)
        self.workload = WorkloadGen(wl, n_experts,
                                    n_layers=self.n_layers_sim)

        self.dies = [DieModel(i) for i in range(sim_cfg.n_sim_dps)]
        # moe_attn deployment: the shared expert pool, folded like the
        # DP groups (faults here degrade EVERY attention DP's MoE stage)
        self.expert_dies = (
            [DieModel(i) for i in range(sim_cfg.n_sim_expert_dies)]
            if sim_cfg.deployment == "moe_attn" else [])
        self.dps = [
            DPGroup(i, CostModelBackend(i, self.cost,
                                        mtp_k=sim_cfg.mtp_k),
                    max_batch=sim_cfg.max_batch, max_len=sim_cfg.max_len,
                    n_kv_blocks=sim_cfg.n_kv_blocks)
            for i in range(sim_cfg.n_sim_dps)
        ]
        try:
            self._wire(sim_cfg, n_experts)
        except BaseException:
            self.close()    # each group runs an output-worker thread
            raise

    def _wire(self, sim_cfg: SimConfig, n_experts: int) -> None:
        """The control plane over the built DP groups: TE-shell,
        reconfigurator, prefill TEs, pod directory, fold maps, metrics."""
        peers = [HeartbeatPeer(f"dp{i}",
                               responder=(lambda i=i: self.dies[i].alive))
                 for i in range(sim_cfg.n_sim_dps)]
        eplb_budget = max(1, self.plan.n_expert
                          - (n_experts or self.plan.n_expert))
        self.shell = TEShell(self.dps, n_layers=self.n_layers_sim,
                             n_experts=n_experts,
                             eplb_budget=eplb_budget,
                             clock=self.loop.clock, dp_peers=peers,
                             eplb_max_slices=8)
        # phased §4.5 reconfiguration: new maps take effect only after
        # the migration traffic has been paid on the UB fabric, then the
        # swap lands on every DP backend via apply_placement
        self.reconfig = ExpertReconfigurator(
            apply_fn=self._activate_maps,
            bytes_per_replica=self.cost.expert_weight_bytes)
        n_long = sim_cfg.long_context_tes
        self.tes = [_PrefillTE(
            i, sim_cfg.prefill_streams_per_te,
            long_capable=(i < n_long if n_long else i == 0),
            long_only=i < n_long,
            token_budget=sim_cfg.prefill_token_budget,
            chunk_tokens=sim_cfg.prefill_chunk_tokens,
            prefix_cache_blocks=sim_cfg.te_prefix_cache_blocks,
            pod=self._te_pod[i])
            for i in range(sim_cfg.n_prefill_tes)]
        # remote pins the pod failure invalidated before the seed read
        # ran: the borrower recomputes the skipped prefix instead
        self._lost_pins: set = set()
        # pod-pooled prefix KV: one directory over every TE's radix
        # directory, kept coherent via the trees' publish/retract hooks
        self.pod_dir: Optional[PodKVDirectory] = None
        if sim_cfg.kv_pool:
            self.pod_dir = PodKVDirectory()
            for te in self.tes:
                self.pod_dir.register(te.te_id, te.prefix_dir)
        # req_id → held RemotePin of a pod remote hit: taken at arrival
        # (owner path eviction-proof from that moment), released when
        # the seeding UB read is priced on the first executed chunk
        self._remote_pins: Dict[int, RemotePin] = {}
        # PD-colocation map: non-dedicated prefill streams share decode
        # dies round-robin; dedicated long-context TEs run on their own
        # hardware (§7.2) and never contend with decode
        self._stream_die: Dict[Tuple[int, int], int] = {}
        if sim_cfg.prefill_colocated:
            g = 0
            for te in self.tes:
                if te.long_only:
                    continue
                for s in range(sim_cfg.prefill_streams_per_te):
                    self._stream_die[(te.te_id, s)] = g % sim_cfg.n_sim_dps
                    g += 1
        self._prefill_busy_until = [0.0] * sim_cfg.n_sim_dps
        self._pending_contended: Dict[int, bool] = {}
        # per-(te, link) FIFO horizon for prefill→decode KV transfers
        self._kv_link_free: Dict[Tuple[int, int], float] = {}
        # DP-domain fold: which §5.2 domain each simulated attention DP
        # belongs to (contiguous split of the folded groups) — a
        # straggling die gates its whole domain's pipeline slot
        nd = max(self.plan.n_dp_domains, 1)
        self._dp_domain = [dp * nd // sim_cfg.n_sim_dps
                           for dp in range(sim_cfg.n_sim_dps)]

        self.die_scale = max(self.plan.n_attention, 1) / sim_cfg.n_sim_dps
        self.metrics = MetricsCollector(n_dies=sim_cfg.total_dies,
                                        die_scale=self.die_scale,
                                        deployment=sim_cfg.deployment)
        self._step_scheduled = [False] * sim_cfg.n_sim_dps
        self._admit_queue: List[Request] = []
        self._admit_pending = False
        self._recent_counts = (
            np.zeros((self.n_layers_sim, n_experts), np.float64)
            if n_experts else None)
        self._map_cache: Dict[int, tuple] = {}
        self._iter_charge: Dict[int, float] = {}
        # physical slots of the ACTIVE PlacementTable (0 until the first
        # EPLB swap lands) — decode_iter_time's placement term
        self._placement_n_phys = 0
        # priced duration of each in-flight decode iteration, popped at
        # execution (cancelled steps never count) — feeds the effective-
        # TPOT accounting (decode_busy_s / n_decode_tokens)
        self._pending_iter_t: Dict[int, float] = {}
        # moe_attn: priced-iteration observables held back until the
        # step actually executes (metrics must not count an iteration a
        # die death cancelled — keeps them aligned with n_decode_iters)
        self._pending_pool_cost: Dict[int, object] = {}
        self.n_arrivals = 0
        self.n_finished = 0
        self._arrivals_scheduled = False

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def _schedule_arrivals(self) -> None:
        for i, (t, req) in enumerate(self.workload.requests()):
            # renumber so req_ids (and the metrics JSON) are independent
            # of how many Requests this process created before the sim
            req.req_id = i
            self.n_arrivals += 1
            self.loop.schedule_at(t, f"arrival:{i}",
                                  lambda t=t, req=req: self._arrive(t, req))
        self._arrivals_scheduled = True

    def _arrive(self, t: float, req: Request) -> None:
        self.metrics.on_arrival(self.loop.now, req)
        self._route(req)

    def _route(self, req: Request) -> None:
        """Route ``req`` to a prefill TE and submit it for chunking.
        Shared by arrivals and pod-failover reroutes (a rerouted request
        re-matches the prefix caches of the surviving pod)."""
        stats = [te.stats(self.loop.now) for te in self.tes if te.alive]
        if self.pod_dir is None:
            te_id = pick_prefill_te(
                stats, req, long_threshold=self.cfg.long_context_threshold)
        else:
            # cache-aware routing: weigh this request's local hit vs
            # best cross-TE remote hit (discounted by the UB read's
            # cost share) on every eligible TE
            te_id = pick_prefill_te(
                stats, req,
                long_threshold=self.cfg.long_context_threshold,
                pod_match_fn=self._pod_match,
                remote_seed_cost=1.0 - self.cost.prefix_remote_seed)
        if getattr(req, "migrate", False):
            te_id = self._migrate_te(te_id, req)
        te = self.tes[te_id]
        te.mean_len = 0.9 * te.mean_len + 0.1 * req.prompt_len
        req.prefill_te = te_id
        if req.prompt_len > self.cfg.long_context_threshold:
            self.metrics.n_long_prompts += 1
            if te.long_only:
                self.metrics.n_long_routed_dedicated += 1
        # radix prefix hit: jump the chunk cursor past the cached block
        # prefix — the scheduler then emits only suffix chunks, so the
        # skip-fraction directly scales the chunk event count
        m = te.prefix_dir.match_blocks(req.prompt_tokens)
        hit_tokens = m.n_tokens
        if self.pod_dir is not None:
            # pod directory: a longer prefix on ANOTHER TE beats the
            # local match — pin the owner's path (eviction-proof until
            # the UB read is priced in _stream_kick) and skip its chunks
            owner, n_blocks = self.pod_dir.match(req.prompt_tokens,
                                                 exclude=te_id)
            if owner is not None and \
                    n_blocks * te.prefix_dir.block_size > m.n_tokens:
                pin = self.pod_dir.acquire(owner, req.prompt_tokens)
                if pin is not None and pin.n_tokens > m.n_tokens:
                    hit_tokens = pin.n_tokens
                    self._remote_pins[req.req_id] = pin
                    self.metrics.n_pod_remote_hits += 1
                    self.metrics.n_pod_remote_hit_tokens += pin.n_tokens
                elif pin is not None:
                    self.pod_dir.release(pin)
        if hit_tokens > 0:
            req.prefill_pos = hit_tokens
            req.prefix_hit_tokens = hit_tokens
            chunk = te.scheduler.chunk_tokens
            cold = -(-req.prompt_len // chunk)
            warm = -(-(req.prompt_len - hit_tokens) // chunk)
            self.metrics.n_prefill_chunks_skipped += cold - warm
            self.metrics.n_prefix_hit_tokens += hit_tokens
            self.metrics.n_prefix_hits += 1
        # remote hits fold into the routing EWMA: a TE serving sessions
        # through the pod directory is warm, not cold
        te.hit_ewma = (0.9 * te.hit_ewma
                       + 0.1 * (hit_tokens / max(req.prompt_len, 1)))
        te.scheduler.submit(req)

    def _pod_match(self, te_id: int, req: Request) -> Tuple[float, float]:
        """(local, remote) hit fractions of `req` were it routed to
        `te_id` — the per-request signal of cache-aware routing."""
        local = self.tes[te_id].prefix_dir.match_fraction(
            req.prompt_tokens)
        remote = self.pod_dir.match_fraction(req.prompt_tokens,
                                             exclude=te_id)
        return local, remote

    def _migrate_te(self, te_id: int, req: Request) -> int:
        """Session-migration: the workload marked this turn as
        re-landing away from its warm TE (session stickiness breaks on
        scale-out, TE drain, front-end rebalancing — the event the
        pod-pooled cache exists to absorb). Rotate to the next TE
        eligible for this request's length class."""
        is_long = req.prompt_len > self.cfg.long_context_threshold
        ok = [t.te_id for t in self.tes if t.alive
              and (t.long_capable if is_long else not t.long_only)]
        if te_id not in ok or len(ok) < 2:
            return te_id
        return ok[(ok.index(te_id) + 1) % len(ok)]

    def _done(self) -> bool:
        return (self._arrivals_scheduled
                and self.n_finished >= self.n_arrivals)

    # -- prefill: chunk-granular events on the main loop ------------------
    def _prefill_tick(self) -> None:
        for te in self.tes:
            if not te.alive:
                continue
            batches = te.scheduler.schedule_step()
            for stream, works in enumerate(batches):
                if works:
                    te.queues[stream].extend(works)
                    self._stream_kick(te, stream)
        if not self._done():
            self.loop.schedule(self.cfg.schedule_interval_s,
                               "prefill_tick", self._prefill_tick)

    def _stream_kick(self, te: _PrefillTE, stream: int) -> None:
        """Start the stream's next chunk (streams execute their FIFO
        serially; the scheduler may run several chunks ahead)."""
        if te.busy[stream] or not te.queues[stream]:
            return
        work = te.queues[stream].popleft()
        te.busy[stream] = True
        te.inflight[stream] = work
        work.req.state = RequestState.PREFILLING
        # 910B-class prefill pods run the chunk at their compute scale
        pod_sl = self._pod_slowdown[te.pod]
        t = self.cost.prefill_chunk_time(
            work.n_tokens, context=work.start,
            n_dies=self.cfg.prefill_dies_per_stream, slowdown=pod_sl)
        hit = work.req.prefix_hit_tokens
        if hit > 0 and work.start == hit:
            pin = self._remote_pins.pop(work.req.req_id, None)
            if pin is None and work.req.req_id in self._lost_pins:
                # the owner pod died between arrival and this seed
                # chunk: the pinned blocks are gone, so the skipped
                # prefix is recomputed in full on this TE
                self._lost_pins.discard(work.req.req_id)
                t += self.cost.prefill_chunk_time(
                    hit, context=0,
                    n_dies=self.cfg.prefill_dies_per_stream,
                    slowdown=pod_sl)
            if pin is not None:
                # pod-pooled remote hit: the seed reads the owner TE's
                # blocks over UB global shared memory — charge the
                # un-saved compute residue (prefix_remote_seed <
                # prefill_hit_skip) plus the read's wire time through
                # the KV link FIFOs (the owner's egress links), then
                # drop the pin: the owner path was eviction-proof from
                # arrival through the read
                waste = 1.0 - self.cost.prefix_remote_seed
                if waste > 0.0:
                    t += waste * self.cost.prefill_chunk_time(
                        hit, context=0,
                        n_dies=self.cfg.prefill_dies_per_stream,
                        slowdown=pod_sl)
                src_pod = self._te_pod[pin.owner]
                kv_t = self.cost.kv_transfer_time(
                    hit, src_pod=src_pod, dst_pod=te.pod)
                read = self._kv_link_delay(pin.owner, stream, kv_t)
                t += read
                self.metrics.n_remote_seed_reads += 1
                self.metrics.remote_seed_read_s += read
                if src_pod != te.pod:
                    self.metrics.n_cross_pod_kv_xfers += 1
                    self.metrics.cross_pod_kv_s += kv_t
                self.pod_dir.release(pin)
            else:
                # first executed chunk after a LOCAL radix skip: seeding
                # the cached prefix saves prefill_hit_skip of its cold
                # compute; the residue (payload assembly, cache-buffer
                # writes) is charged here (1.0 ⇒ seeding is free)
                waste = 1.0 - self.cost.prefill_hit_skip
                if waste > 0.0:
                    t += waste * self.cost.prefill_chunk_time(
                        hit, context=0,
                        n_dies=self.cfg.prefill_dies_per_stream,
                        slowdown=pod_sl)
        die = self._stream_die.get((te.te_id, stream))
        if die is not None:
            # decode iterations overlapping [now, now+t] on this die
            # pay the prefill contention factor
            self._prefill_busy_until[die] = max(
                self._prefill_busy_until[die], self.loop.now + t)
        self.loop.schedule(
            t, f"prefill_chunk:te{te.te_id}.s{stream}:{work.req.req_id}",
            lambda te=te, stream=stream, work=work:
                self._chunk_done(te, stream, work))

    def _chunk_done(self, te: _PrefillTE, stream: int,
                    work: ChunkWork) -> None:
        """One chunk finished: its KV layers start streaming to the
        decode side immediately (overlapped with the next chunk's
        compute), so only the FINAL chunk's wire time sits on the TTFT
        path — the pre-chunking model charged the whole cache's transfer
        after the whole prompt."""
        if not te.alive:
            # the TE's pod died while this chunk executed: the work was
            # already recovered and rerouted by _kill_pod — drop it
            return
        te.busy[stream] = False
        te.inflight[stream] = None
        self.metrics.n_prefill_chunks += 1
        req = work.req
        if work.end >= req.prompt_len:
            te.prefix_dir.insert(req.prompt_tokens)
            req.state = RequestState.TRANSFERRING
            # the final chunk's KV streams to the decode pod: cross-pod
            # TEs price the wire over the scale-out fabric (RoCE)
            kv_t = self.cost.kv_transfer_time(
                work.n_tokens, src_pod=te.pod,
                dst_pod=self.cfg.decode_pod)
            if te.pod != self.cfg.decode_pod:
                self.metrics.n_cross_pod_kv_xfers += 1
                self.metrics.cross_pod_kv_s += kv_t
            delay = self._kv_link_delay(te.te_id, stream, kv_t)
            self.loop.schedule(delay, f"kv_done:{req.req_id}",
                               lambda req=req: self._enqueue_admit(req))
        self._stream_kick(te, stream)

    def _kv_link_delay(self, te_id: int, stream: int,
                       kv_t: float) -> float:
        """FIFO queueing on the TE's KV egress links: streams multiplex
        over ``n_kv_links_per_te`` links round-robin, and a transfer
        whose link is still draining an earlier ChunkStream waits for
        it. Returns wait + wire time (just the wire time when
        ``kv_link_fifo`` is off — the legacy uncontended model).

        In the ``moe_attn`` deployment KV does not leave the TE on a
        private egress bundle — it lands in the shared attention pool
        over the pool's ingress links, so EVERY TE's streams multiplex
        over the same ``n_kv_links_per_te`` links (previously the knob
        silently priced moe_attn exactly like colocated per-TE
        egress)."""
        if not self.cfg.kv_link_fifo:
            return kv_t
        n_links = max(self.cfg.n_kv_links_per_te, 1)
        if self.cfg.deployment == "moe_attn":
            link = (-1, (te_id * self.cfg.prefill_streams_per_te
                         + stream) % n_links)
        else:
            link = (te_id, stream % n_links)
        now = self.loop.now
        start = max(now, self._kv_link_free.get(link, 0.0))
        if start > now:
            self.metrics.n_kv_xfers_queued += 1
            self.metrics.kv_link_wait_s += start - now
        self._kv_link_free[link] = start + kv_t
        return (start - now) + kv_t

    # -- decode admission -------------------------------------------------
    def _enqueue_admit(self, req: Request) -> None:
        self._admit_queue.append(req)
        if not self._admit_pending:
            self._admit_pending = True
            self.loop.schedule(0.0, "admit_drain", self._admit_drain)

    def _admit_drain(self) -> None:
        self._admit_pending = False
        remaining: List[Request] = []
        for req in self._admit_queue:
            dp_id = self.shell.dispatch(req)
            dp = None
            if dp_id is not None:
                dp = next(d for d in self.dps if d.dp_id == dp_id)
                if not self.dies[dp_id].alive or not dp.can_admit(req):
                    dp = None
            if dp is None:
                remaining.append(req)
                continue
            cache1, logits = dp.run_prefill(req)
            dp.admit(req, cache1, logits)
            self.metrics.on_first_token(self.loop.now, req)
            self._kick(dp_id)
        self._admit_queue = remaining
        if remaining and not self._done():
            self._admit_pending = True
            self.loop.schedule(self.cfg.admit_retry_s, "admit_drain",
                               self._admit_drain)

    # -- decode loop ------------------------------------------------------
    def _map_arrays(self, layer: int, em) -> tuple:
        """Vectorized (expert_idx, npu_idx, inv_replicas) view of one
        layer's ExpertMap, cached per (layer, map object) — identity is
        held via the object itself (an id() key could collide after the
        old map is freed)."""
        cached = self._map_cache.get(layer)
        if cached is not None and cached[0] is em:
            return cached[1]
        n_npus = max(self.plan.n_expert, 1)
        exp_idx: List[int] = []
        npu_idx: List[int] = []
        inv_rep: List[float] = []
        for e, slots in em.replicas.items():
            for s in slots:
                exp_idx.append(e)
                npu_idx.append(em.slot_npu.get(s, s % n_npus) % n_npus)
                inv_rep.append(1.0 / len(slots))
        arrays = (np.asarray(exp_idx, np.int64),
                  np.asarray(npu_idx, np.int64),
                  np.asarray(inv_rep, np.float64))
        self._map_cache[layer] = (em, arrays)
        return arrays

    def _layer_imbalance(self, layer: int, counts: np.ndarray) -> float:
        """Hottest-expert-die load over the pod mean for ONE simulated
        MoE layer, under that layer's active EPLB map."""
        if counts.sum() <= 0:
            return 1.0
        n_npus = max(self.plan.n_expert, 1)
        em = self.shell.expert_maps.get(layer)
        load = np.zeros(n_npus, np.float64)
        if em is None or not self.cfg.eplb_enabled:
            np.add.at(load, np.arange(len(counts)) % n_npus, counts)
        else:
            exp_idx, npu_idx, inv_rep = self._map_arrays(layer, em)
            np.add.at(load, npu_idx, counts[exp_idx] * inv_rep)
        mean = counts.sum() / n_npus
        return float(np.clip(load.max() / max(mean, 1e-9), 1.0,
                             MAX_IMBALANCE))

    def _moe_imbalance(self):
        """Per-layer imbalance vector [n_layers_sim] (the cost model
        prices each simulated layer's share of the iteration with its
        own value); scalar 1.0 when no routing stats exist yet."""
        c = self._recent_counts
        if c is None or c.sum() <= 0:
            return 1.0
        return np.asarray([self._layer_imbalance(l, c[l])
                           for l in range(c.shape[0])])

    def _expert_pool_factor(self) -> float:
        """Effective MoE-stage slowdown from expert-pool health
        (``moe_attn`` deployment). The EP all-to-all makes every
        attention DP dispatch to every expert die, so the hottest
        surviving die gates the expert stage for the WHOLE pod; a dead
        die's experts fall onto the survivors (capacity factor
        ``n / n_alive`` — §6.2 redistributes, it does not drop)."""
        if not self.expert_dies:
            return 1.0
        alive = [d for d in self.expert_dies if d.alive]
        if not alive:
            return MAX_IMBALANCE          # pool gone: decode crawls
        cap = len(self.expert_dies) / len(alive)
        return cap * max(d.slowdown for d in alive)

    def _domain_attn_slowdown(self, dp_id: int) -> float:
        """Max die slowdown across ``dp_id``'s DP DOMAIN: the §5.2
        pipeline time-multiplexes whole domains through the expert-stage
        slot, so a straggling attention die gates every domain-mate's
        pipeline, not just its own folded group."""
        dom = self._dp_domain[dp_id]
        return max(die.slowdown
                   for dp, die in enumerate(self.dies)
                   if self._dp_domain[dp] == dom)

    def _iter_time(self, dp_id: int) -> float:
        dp = self.dps[dp_id]
        positions = [s.position for s in dp.slots if not s.free]
        ctx = int(np.mean(positions)) if positions else 0
        if self.cfg.deployment == "moe_attn":
            c = self.cost.moe_attn_decode_iter_time(
                len(positions), mean_context=max(ctx, 1),
                moe_imbalance=self._moe_imbalance(),
                slowdown=self.dies[dp_id].slowdown,
                expert_slowdown=self._expert_pool_factor(),
                attn_stage_slowdown=self._domain_attn_slowdown(dp_id))
            self._pending_pool_cost[dp_id] = c
            t = c.t_iter
        else:
            t = self.cost.decode_iter_time(
                len(positions), mean_context=max(ctx, 1),
                moe_imbalance=self._moe_imbalance(),
                slowdown=self.dies[dp_id].slowdown,
                mtp_k=self.cfg.mtp_k,
                placement_slots=self._placement_n_phys)
            if self.loop.now < self._prefill_busy_until[dp_id]:
                # a prefill chunk is executing on this die: the decode
                # iteration pays the colocation contention factor
                t *= self.cost.prefill_decode_contention
                self._pending_contended[dp_id] = True
        # in-flight EPLB migration: the next iteration eats the weight
        # traffic's UB contention (charged once per pass per DP; in the
        # moe_attn deployment that traffic rides the expert pool's UB
        # links — same fabric constants, §4.5)
        return t + self._iter_charge.pop(dp_id, 0.0)

    def _kick(self, dp_id: int) -> None:
        if self._step_scheduled[dp_id] or not self.dies[dp_id].alive:
            return
        if self.dps[dp_id].active == 0:
            return
        self._step_scheduled[dp_id] = True
        t = self._iter_time(dp_id)
        self._pending_iter_t[dp_id] = t
        self.loop.schedule(t, f"dp_step:{dp_id}",
                           lambda: self._dp_step(dp_id))

    def _dp_step(self, dp_id: int) -> None:
        self._step_scheduled[dp_id] = False
        dp = self.dps[dp_id]
        if not self.dies[dp_id].alive or dp.active == 0:
            self._pending_pool_cost.pop(dp_id, None)   # step cancelled
            self._pending_contended.pop(dp_id, None)
            self._pending_iter_t.pop(dp_id, None)
            return
        active = dp.active_requests()
        # tokens-per-step-aware timestamping: an MTP iteration can emit
        # 1..k+1 tokens per request, all stamped at this iteration's
        # completion (n_emitted deltas; exactly 1 each when MTP is off,
        # so the pre-MTP event stream is reproduced byte-identically)
        emitted_before = [req.n_emitted for req in active]
        dp.decode_step_all()
        now = self.loop.now
        self.metrics.n_decode_iters += 1
        t_iter = self._pending_iter_t.pop(dp_id, 0.0)
        self.metrics.decode_busy_s += t_iter
        self.metrics.n_slot_iters += len(active)
        self.metrics.decode_slot_busy_s += t_iter * len(active)
        if self._pending_contended.pop(dp_id, None):
            self.metrics.n_contended_decode_iters += 1
        c = self._pending_pool_cost.pop(dp_id, None)
        if c is not None:
            self.metrics.on_moe_attn_iter(c)
        for req, n_before in zip(active, emitted_before):
            for _ in range(req.n_emitted - n_before):
                self.metrics.on_token(now, req)
            if req.state == RequestState.FINISHED:
                self.metrics.on_finish(now, req)
                self.n_finished += 1
        if self._recent_counts is not None:
            counts = self.workload.expert_counts(
                len(active), self.model_cfg.moe.top_k)   # [L, E]
            self._recent_counts = 0.9 * self._recent_counts + counts
            self.shell.record_expert_counts(counts)
        dp.finished = []
        self._kick(dp_id)

    # -- control-plane periodics -----------------------------------------
    def _activate_maps(self, maps) -> None:
        """Reconfigurator swap callback: maps go live for per-layer
        pricing and the PlacementTable lands on every alive DP backend
        through the apply_placement contract."""
        table = self.shell.activate_maps(maps, push_to_dps=False)
        self._placement_n_phys = table.n_physical if table is not None \
            else 0
        for dp, die in zip(self.dps, self.dies):
            if die.alive:
                dp.apply_placement(table)
        self.metrics.n_reconfigs += 1

    def _eplb_tick(self) -> None:
        if (self.cfg.eplb_enabled and self.shell.collector is not None
                and self.reconfig.state in (ReconfigState.IDLE,
                                            ReconfigState.ENABLED)):
            maps = self.shell.plan_eplb(
                n_npus=self.plan.n_expert,
                slots_per_npu=max(
                    1, self.model_cfg.moe.redundancy_slots))
            if maps and not self.cfg.eplb_per_layer:
                # layer-0-only policy: one map replayed on every layer
                maps = {layer: maps[0] for layer in maps}
            if maps:
                plan = self.reconfig.begin(maps)
                # §4.5 phases priced on the UB fabric: prefetch, then
                # shadow-load, each bounded by the hottest receiving
                # NPU's weight traffic; the swap fires when both are
                # paid. Serving is never interrupted, but a decoding
                # DP's next iteration eats the migration's link
                # contention (idle groups see no traffic to contend
                # with). Migration bytes/time are accounted at the SWAP
                # — a migration cut off by the run deadline charged
                # nothing, keeping metrics == reconfigurator counters.
                t_phase = self.cost.reconfig_transfer_time(
                    plan.hottest_npu_loads)
                self.metrics.n_eplb_passes += 1
                for dp_id, die in enumerate(self.dies):
                    if (die.alive and t_phase > 0
                            and self.dps[dp_id].active > 0):
                        self._iter_charge[dp_id] = \
                            self._iter_charge.get(dp_id, 0.0) + t_phase
                self.loop.schedule(t_phase, "eplb_prefetch_done",
                                   self.reconfig.step)
                self.loop.schedule(2.0 * t_phase, "eplb_load_done",
                                   lambda: self._eplb_swap(t_phase))
        if not self._done():
            self.loop.schedule(self.cfg.eplb_interval_s, "eplb_tick",
                               self._eplb_tick)

    def _eplb_swap(self, t_phase: float) -> None:
        self.reconfig.step()          # SHADOW_LOADING → READY
        self.reconfig.step()          # READY → ENABLED (apply_fn swap)
        plan = self.reconfig.plan
        if plan is not None:
            self.metrics.reconfig_bytes += plan.total_bytes
            self.metrics.reconfig_time_s += 2.0 * t_phase

    def _health_tick(self) -> None:
        failed = self.shell.health_tick()
        for name in failed:
            self._failover(int(name[2:]))
        if not self._done():
            self.loop.schedule(self.cfg.heartbeat_interval_s,
                               "health_tick", self._health_tick)

    def _failover(self, dp_id: int) -> None:
        """Dead-DP recovery: evict active requests, recompute their
        context elsewhere (§6.2 token recomputation across DP groups)."""
        dp = self.dps[dp_id]
        for slot_id in range(len(dp.slots)):
            req = dp.evict(slot_id)
            if req is None:
                continue
            self.metrics.on_failover(req)
            # re-prefill prompt + tokens generated so far on the new DP.
            # Synthesize the generated suffix from the synchronous
            # n_emitted counter — req.output_tokens is appended by the
            # async output worker, so reading it here would make the
            # trace depend on thread timing.
            req.prompt_tokens = list(req.prompt_tokens) \
                + [2 + (req.req_id + j) % 50
                   for j in range(req.n_emitted)]
            t_re = self.cost.prefill_time(
                req.prompt_len, n_dies=self.cfg.prefill_dies_per_stream)
            self.loop.schedule(t_re, f"failover_admit:{req.req_id}",
                               lambda req=req: self._enqueue_admit(req))

    def _kv_tick(self) -> None:
        alive = [d for d, die in zip(self.dps, self.dies) if die.alive]
        usage = (float(np.mean([d.allocator.usage for d in alive]))
                 if alive else 0.0)
        self.metrics.sample_kv(self.loop.now, usage)
        if not self._done():
            self.loop.schedule(self.cfg.kv_sample_interval_s, "kv_tick",
                               self._kv_tick)

    def _schedule_faults(self) -> None:
        """Pool-aware injection: attention-pool faults hit one DP group
        (heartbeat failover recovers its requests); expert-pool faults
        hit the shared pool and degrade every attention DP's MoE stage
        through ``_expert_pool_factor`` — no requests move, the whole
        pod's TPOT stretches instead."""
        f = self.faults
        if f.straggler_dp is not None:
            pool = (self.expert_dies if f.straggler_pool == "expert"
                    else self.dies)
            def slow(pool=pool):
                pool[f.straggler_dp].slowdown = f.straggler_slowdown
            self.loop.schedule_at(
                f.straggler_at,
                f"fault:straggler:{f.straggler_pool}:{f.straggler_dp}",
                slow)
        if f.dead_dp is not None:
            pool = (self.expert_dies if f.dead_pool == "expert"
                    else self.dies)
            def kill(pool=pool):
                pool[f.dead_dp].alive = False
            self.loop.schedule_at(
                f.dead_at, f"fault:dead:{f.dead_pool}:{f.dead_dp}", kill)
        if f.dead_pod_id is not None:
            self.loop.schedule_at(
                f.dead_pod_at, f"fault:dead_pod:{f.dead_pod_id}",
                lambda: self._kill_pod(f.dead_pod_id))

    def _kill_pod(self, pod_id: int) -> None:
        """Pod-level failure domain (§6 / P/D-Serve): every prefill TE
        in ``pod_id`` dies at once. All of its prefill work — queued,
        partially prefilled, emitted chunks, and the chunks executing
        right now — is recovered and rerouted to the surviving pod(s)
        with chunk cursors reset: the partial KV on the dead pod is
        lost, so prefill restarts (§6.2 recompute). Remote pins against
        dead owners are dropped; their borrowers recompute the skipped
        prefix. Requests already past prefill (KV landed on the decode
        pod) are untouched."""
        self.metrics.n_pod_failovers += 1
        dead_tes = [te for te in self.tes
                    if te.pod == pod_id and te.alive]
        # pins whose OWNER died: release before the trees leave the
        # directory, and flag the borrower for full prefix recompute
        for rid, pin in list(self._remote_pins.items()):
            if self.tes[pin.owner] in dead_tes:
                del self._remote_pins[rid]
                self.pod_dir.release(pin)
                self._lost_pins.add(rid)
        lost: List[Request] = []
        seen = set()

        def recover(req: Request) -> None:
            if req.req_id not in seen:
                seen.add(req.req_id)
                lost.append(req)

        for te in dead_tes:
            te.alive = False
            # partially-prefilled requests pinned to the TE's streams
            for s in range(len(te.queues)):
                for req in te.scheduler.requeue_dp(s):
                    recover(req)
            # queued requests the scheduler never started
            for req in te.scheduler.queue:
                recover(req)
            te.scheduler.queue.clear()
            # emitted-but-unexecuted chunks and the executing ones (the
            # scheduler no longer tracks fully-emitted requests)
            for q in te.queues:
                for w in q:
                    recover(w.req)
                q.clear()
            for s, w in enumerate(te.inflight):
                if w is not None:
                    recover(w.req)
                te.inflight[s] = None
            te.busy = [False] * len(te.busy)
            # retract the dead TE's published prefixes so pod-directory
            # matches stop landing on unreachable blocks
            if self.pod_dir is not None:
                self.pod_dir.unregister(te.te_id)
        for req in lost:
            # the request's own pin (taken at arrival, owner may be
            # anywhere): drop it — routing restarts from scratch
            pin = self._remote_pins.pop(req.req_id, None)
            if pin is not None:
                self.pod_dir.release(pin)
            self._lost_pins.discard(req.req_id)
            req.state = RequestState.QUEUED
            req.prefill_pos = 0
            req.prefix_hit_tokens = 0
            self.metrics.n_pod_reroutes += 1
            self._route(req)

    # ------------------------------------------------------------------
    def run(self) -> SimReport:
        self._schedule_arrivals()
        self._schedule_faults()
        self.loop.schedule(0.0, "prefill_tick", self._prefill_tick)
        self.loop.schedule(0.0, "kv_tick", self._kv_tick)
        self.loop.schedule(self.cfg.heartbeat_interval_s, "health_tick",
                           self._health_tick)
        self.loop.schedule(self.cfg.eplb_interval_s, "eplb_tick",
                           self._eplb_tick)
        deadline = self.workload.cfg.duration_s + self.cfg.drain_timeout_s
        try:
            self.loop.run(until=deadline)
            for d in self.dps:
                d.drain()
        finally:
            self.close()
        return self.metrics.report(self.loop.now, self.loop.trace)

    def close(self) -> None:
        """Join every DP group's output-worker thread (``run`` does; a
        sim that is never run should call it). Idempotent."""
        for d in self.dps:
            d.close()
