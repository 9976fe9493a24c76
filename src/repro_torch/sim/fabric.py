"""Die + fabric model: roofline-derived compute, XCCL-derived comm.

Every time here is a MODELED CloudMatrix384 time, never the card's. The
simulated die's peak FLOPs and HBM bandwidth are the module constants
below, and link/transfer latencies come from
``repro_torch.xccl.topology`` (MTE/DMA engines, dispatch & A2E models
calibrated to the paper's Fig. 5/6). The cost model prices one decode
iteration of a DP group under the active :class:`PartitionPlan` — the
same 288-expert/480-attention split the paper deploys — including the
§4.4 microbatch compute/comm overlap and an EPLB-visible expert
imbalance term, so hot experts and slow dies show up in simulated TPOT
exactly where they would on hardware. Measured rows replace constants
through :meth:`SuperPodCostModel.from_calibration`.

The arithmetic is host Python and numpy floats, operation for operation
the reference simulator's: the report's trace digest hashes every event
time to 9 decimals, so a reassociated sum would change it.

``CostModelBackend`` is the execution stub a simulated
:class:`~repro_torch.serving.dp_group.DPGroup` runs on: no tensors,
deterministic pseudo-logits, and per-call accounting of the virtual time
each forward would have taken.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import MOE, ModelConfig
from repro_torch.core.transformerless import PartitionPlan
from repro_torch.serving.backend import ExecutionBackend
from repro_torch.xccl.topology import (PodTopology, SuperPod,
                                       a2e_latency_model,
                                       best_transfer_time,
                                       dispatch_latency_model)

# The simulated die's peak bf16 FLOP/s and HBM bytes/s: inputs of the
# modeled pod, equal to the reference simulator's (its roofline module's
# per-chip constants), so seeded reports match it byte for byte. They
# describe no card this package runs on.
PEAK_FLOPS = 197e12
HBM_BW = 819e9

# Achievable fractions of peak (decode batches are small and latency
# bound; prefill runs large fused matmuls). Calibrated so the DeepSeek-V3
# 288/480 plan lands in the paper's §7.1 decade (~50-70 ms TPOT and
# >1000 tok/s/die at batch-per-die 96).
DECODE_MFU = 0.55
PREFILL_MFU = 0.45
HBM_EFF = 0.85
# §4.1: expert GEMMs run INT8 (W8A8) — twice the bf16 MACs per cycle
INT8_MOE_SPEEDUP = 2.0
# host-side per-iteration overhead (sampling, scheduling, launch)
ITER_OVERHEAD = 1.0e-3
# §5.2 disaggregated expert pool: fixed per-(domain, microbatch) cost of
# one expert-stage visit (persistent-kernel poll + grouped-GEMM launch +
# A2E doorbell handling on the expert die). The colocated deployment
# fuses this into the layer program; paying it nd·mb times per layer is
# what makes MoE-Attention disaggregation lose at small batch-per-die
# (MegaScale-Infer's dispatch-latency regime).
EXPERT_OP_OVERHEAD = 40.0e-6
# chunked prefill: fixed per-chunk cost (launch + bucketed-shape program
# switch + scheduler hand-back) — the price of slicing a prompt, paid
# once per chunk instead of once per prompt
PREFILL_CHUNK_OVERHEAD = 0.5e-3
# PD-colocated interference: a decode iteration that overlaps a prefill
# chunk on the same die stretches by this factor (the prefill GEMMs hog
# cube units and HBM bandwidth). Calibratable from the measured
# interleaved decode/prefill loop in bench_prefill_interference
# (``prefill/decode_contention`` row).
PREFILL_DECODE_CONTENTION = 1.6


@dataclasses.dataclass
class DieModel:
    """One accelerator die. ``slowdown`` > 1 models a straggler (thermal
    throttling, HBM error-correction storms); ``alive=False`` a dead die.
    """
    die_id: int
    slowdown: float = 1.0
    alive: bool = True


@dataclasses.dataclass
class MoEAttnIterCost:
    """Priced decode iteration of one attention-pool DP group under the
    ``moe_attn`` deployment, plus the per-pool observables the metrics
    collector aggregates (utilizations are fractions of the MoE-layer
    pipeline window; byte counts are per attention die per iteration)."""
    t_iter: float
    t_pipeline: float          # MoE-layer pipeline share of the iteration
    attn_busy_frac: float      # attention-pool busy fraction of pipeline
    expert_busy_frac: float    # expert-compute stream busy fraction
    bubble_frac: float         # expert-pool idle share (pipeline bubbles)
    a2e_bytes: int             # INT8 payload + scales dispatched
    e2a_bytes: int             # bf16 combine payload returned


@dataclasses.dataclass
class FabricModel:
    """Transfer-latency view of the pod fabric (delegates to XCCL's
    engine models; ``fabric`` picks UB / RoCE / VPC constants).

    With a :class:`~repro_torch.xccl.topology.PodTopology` attached, pricing
    becomes per-path: intra-pod transfers ride ``fabric`` (the scale-up
    plane), cross-pod paths the topology's scale-out link (RoCE). With
    ``topology=None`` every path is intra-pod — the single-SuperPod view,
    numerically identical to the pre-pod model."""
    fabric: str = "ub"
    pod: SuperPod = dataclasses.field(default_factory=SuperPod)
    topology: Optional[PodTopology] = None

    def link_fabric(self, src_pod: int = 0, dst_pod: int = 0) -> str:
        if self.topology is None or src_pod == dst_pod:
            return self.fabric
        return self.topology.link(src_pod, dst_pod)

    def transfer_time(self, nbytes: int, src_pod: int = 0,
                      dst_pod: int = 0) -> float:
        return best_transfer_time(int(nbytes),
                                  self.link_fabric(src_pod, dst_pod))

    def kv_transfer_time(self, n_tokens: int,
                         kv_bytes_per_token: float,
                         src_pod: int = 0, dst_pod: int = 0) -> float:
        return self.transfer_time(int(n_tokens * kv_bytes_per_token),
                                  src_pod, dst_pod)


class SuperPodCostModel:
    """Prices prefill forwards and decode iterations for one config +
    partition plan at SuperPod scale.

    The hand-calibrated constants (``DECODE_MFU``, ``HBM_EFF``,
    ``INT8_MOE_SPEEDUP``, ``ITER_OVERHEAD``) are instance attributes so
    :meth:`from_calibration` can replace them — and the dispatch/combine
    latency curve — with numbers measured by the repo's own benchmarks
    (``BENCH_dispatch_combine.json`` / ``BENCH_decode_iteration.json``),
    keeping the simulator tracking the real kernels as they improve.
    ``chip_smoke.py`` writes two such rows measured on the card
    (``decode/iter_overhead``, ``prefill/hit_skip``).
    """

    def __init__(self, cfg: ModelConfig, plan: PartitionPlan,
                 fabric: Optional[FabricModel] = None,
                 mean_context: int = 4096):
        self.cfg = cfg
        self.plan = plan
        self.fabric = fabric or FabricModel()
        self.mean_context = mean_context
        self.decode_mfu = DECODE_MFU
        self.prefill_mfu = PREFILL_MFU
        self.hbm_eff = HBM_EFF
        self.int8_moe_speedup = INT8_MOE_SPEEDUP
        self.iter_overhead = ITER_OVERHEAD
        self.expert_op_overhead = EXPERT_OP_OVERHEAD
        self.prefill_chunk_overhead = PREFILL_CHUNK_OVERHEAD
        self.prefill_decode_contention = PREFILL_DECODE_CONTENTION
        # prefix-cache hit efficiency: fraction of a cached prefix's cold
        # prefill compute actually saved on a radix hit (1.0 = seeding
        # from stored KV is free; < 1.0 charges the residue — payload
        # assembly, cache-buffer writes — as measured by
        # bench_prefix_cache's ``prefill/hit_skip`` row)
        self.prefill_hit_skip = 1.0
        # pod-pooled prefix cache: fraction of the replaced prefill
        # compute a REMOTE hit saves (< prefill_hit_skip — the borrower
        # still assembles/seeds, and the owner-side block gather is not
        # free; the UB wire time itself is priced separately through
        # kv_transfer_time on the owner's egress links). Measured by
        # bench_prefix_cache's ``prefix/remote_seed`` row.
        self.prefix_remote_seed = 0.85
        # §4.6 MTP speculative decoding: per-draft acceptance probability
        # (paper reports ~90% for the DeepSeek MTP head; the engine draws
        # per-iteration accepted lengths from it) and, when measured by
        # bench_mtp, the seconds one draft-head pass adds to an iteration
        # (None ⇒ analytic one-block estimate in decode_iter_time)
        self.mtp_acceptance = 0.9
        self.mtp_draft_overhead: Optional[float] = None
        # §4.5 EPLB placement data plane: `placement_gather_free` says
        # the decode path runs the owner-indexed GMM
        # (kernels/gmm.placement_gmm — replica slots are extra grouped-
        # matmul rows, no per-step weight gather). False prices the
        # legacy owner-gathered path: every placement-active step
        # materializes [n_phys, d, f] weights per MoE layer (write +
        # re-read of pure HBM traffic). `placement_gmm_overhead`
        # (seconds), when measured by bench_placement_gmm's
        # ``eplb/placement_gmm`` row, is the residual per-layer cost the
        # owner-indexed GMM adds over the plain grouped matmul.
        self.placement_gather_free = True
        self.placement_gmm_overhead: Optional[float] = None
        # measured dispatch/combine curve: sorted [(bpd, t_disp_s,
        # t_comb_s)] interpolated in decode_iter_time when present
        self._calib_comm: Optional[List[Tuple[float, float, float]]] = None
        # measured prefill chunk-time curve: sorted [(chunk_tokens, t_s)]
        self._calib_prefill: Optional[List[Tuple[float, float]]] = None
        self._derive()

    # ------------------------------------------------------------------
    # calibration from benchmark JSON (ROADMAP: "calibrate cost stubs
    # against real kernel benches")
    # ------------------------------------------------------------------
    @classmethod
    def from_calibration(cls, cfg: ModelConfig, plan: PartitionPlan,
                         paths: Union[str, Sequence[str]],
                         fabric: Optional[FabricModel] = None,
                         mean_context: int = 4096,
                         **const_overrides: float) -> "SuperPodCostModel":
        """Build a cost model whose kernel times come from measured
        benchmark emissions (``benchmarks.common.write_json`` files).

        Recognized rows:

        * ``fig6/dispatch/bpd<N>`` — dispatch µs (``us_per_call``) and
          combine µs (``combine_us=`` in ``derived``) at batch-per-die
          ``N`` → replaces ``dispatch_latency_model`` by interpolation.
        * ``decode/iter_overhead`` — measured host-side per-iteration
          overhead in µs → replaces ``ITER_OVERHEAD``.
        * ``disagg/expert_op_overhead`` — measured per-(domain,
          microbatch) expert-stage visit cost in µs → replaces
          ``EXPERT_OP_OVERHEAD`` in the ``moe_attn`` deployment rows.
        * ``prefill/chunk_time/c<N>`` — measured chunked-prefill time in
          µs for an ``N``-token chunk (``bench_prefill_interference``) →
          replaces the analytic compute term of
          :meth:`prefill_chunk_time` by interpolation over chunk sizes.
        * ``prefill/decode_contention`` — measured decode-iteration
          stretch factor while a prefill chunk shares the die
          (DIMENSIONLESS ratio carried in the ``us_per_call`` column) →
          replaces ``PREFILL_DECODE_CONTENTION``.
        * ``prefill/hit_skip`` — measured fraction of a cached prefix's
          cold prefill compute saved by seeding from the radix cache
          (DIMENSIONLESS in ``us_per_call``, clipped to [0, 1];
          ``bench_prefix_cache``) → replaces ``prefill_hit_skip``.
        * ``prefix/remote_seed`` — measured fraction of the replaced
          prefill compute a POD-POOLED remote hit saves (UB read +
          assembly + seeding vs recompute; DIMENSIONLESS in
          ``us_per_call``, clipped to [0, 1]; ``bench_prefix_cache``) →
          replaces ``prefix_remote_seed``.
        * ``mtp/acceptance`` — measured per-draft acceptance probability
          of the MTP head (DIMENSIONLESS in ``us_per_call``, clipped to
          [0, 1]; ``bench_mtp``) → replaces ``mtp_acceptance``.
        * ``mtp/draft_overhead`` — measured extra time one draft-head
          pass adds to a decode iteration in µs (``bench_mtp``) →
          replaces the analytic draft term of :meth:`decode_iter_time`.
        * ``eplb/placement_gmm`` — measured extra time one placement-
          active MoE layer's owner-indexed GMM adds over the plain
          grouped matmul in µs (``bench_placement_gmm``) → replaces the
          analytic placement term of :meth:`decode_iter_time`.

        Extra keyword args override constants directly
        (``decode_mfu=0.6``, ``int8_moe_speedup=1.8``, …).
        """
        self = cls(cfg, plan, fabric, mean_context)
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        rows: List[Dict[str, Any]] = []
        for p in paths:
            with open(p) as f:
                rows.extend(json.load(f).get("rows", []))
        comm: List[Tuple[float, float, float]] = []
        pref: List[Tuple[float, float]] = []
        for row in rows:
            name = row.get("name", "")
            if name.startswith("fig6/dispatch/bpd"):
                bpd = float(name.rsplit("bpd", 1)[1])
                t_disp = float(row["us_per_call"]) * 1e-6
                t_comb = t_disp
                for part in str(row.get("derived", "")).split():
                    if part.startswith("combine_us="):
                        t_comb = float(part.split("=", 1)[1]) * 1e-6
                comm.append((bpd, t_disp, t_comb))
            elif name == "decode/iter_overhead":
                self.iter_overhead = float(row["us_per_call"]) * 1e-6
            elif name == "disagg/expert_op_overhead":
                self.expert_op_overhead = float(row["us_per_call"]) * 1e-6
            elif name.startswith("prefill/chunk_time/c"):
                chunk = float(name.rsplit("c", 1)[1])
                pref.append((chunk, float(row["us_per_call"]) * 1e-6))
            elif name == "prefill/decode_contention":
                self.prefill_decode_contention = max(
                    float(row["us_per_call"]), 1.0)
            elif name == "prefill/hit_skip":
                self.prefill_hit_skip = float(
                    np.clip(float(row["us_per_call"]), 0.0, 1.0))
            elif name == "prefix/remote_seed":
                self.prefix_remote_seed = float(
                    np.clip(float(row["us_per_call"]), 0.0, 1.0))
            elif name == "mtp/acceptance":
                self.mtp_acceptance = float(
                    np.clip(float(row["us_per_call"]), 0.0, 1.0))
            elif name == "mtp/draft_overhead":
                self.mtp_draft_overhead = float(row["us_per_call"]) * 1e-6
            elif name == "eplb/placement_gmm":
                self.placement_gmm_overhead = \
                    float(row["us_per_call"]) * 1e-6
        if comm:
            self._calib_comm = sorted(comm)
        if pref:
            self._calib_prefill = sorted(pref)
        for k, v in const_overrides.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown cost constant {k!r}")
            setattr(self, k, float(v))
        return self

    def _comm_times(self, batch_per_die: float) -> Tuple[float, float]:
        """(dispatch, combine) seconds at this batch — measured curve if
        calibrated, analytic XCCL model otherwise.

        The 288/480 plans are the §3.3 MoE-Attention disaggregated
        deployment, so the analytic path prices A2E/E2A with the
        trampoline-forward model (metadata O(n_attn + n_expert)), not
        the colocated EP-scatter ``dispatch_latency_model`` (metadata
        O(E) — the scalar-throughput wall the trampoline exists to
        avoid). The colocated model is kept for plans with no separate
        attention dies."""
        e = self.cfg.moe
        if self._calib_comm:
            xs = [c[0] for c in self._calib_comm]
            t_disp = float(np.interp(batch_per_die, xs,
                                     [c[1] for c in self._calib_comm]))
            t_comb = float(np.interp(batch_per_die, xs,
                                     [c[2] for c in self._calib_comm]))
            return t_disp, t_comb
        plan = self.plan
        if plan.n_attention > 0 and plan.dp_groups_per_domain > 0:
            t_a2e = a2e_latency_model(plan.dp_groups_per_domain,
                                      plan.n_expert, batch_per_die,
                                      self.cfg.d_model, e.top_k)
            # E2A reverses the two stages; bf16 payload back ≈ 1.15×
            return t_a2e, t_a2e * 1.15
        t_disp = dispatch_latency_model(
            batch_per_die, self.cfg.d_model, plan.n_expert, e.top_k,
            quantized=True)
        t_comb = dispatch_latency_model(
            batch_per_die, self.cfg.d_model, plan.n_expert, e.top_k,
            quantized=False)
        return t_disp, t_comb

    # -- per-layer analytic terms (mirrors plan_partition's FLOP model) --
    def _derive(self) -> None:
        cfg = self.cfg
        d = cfg.d_model
        kinds = cfg.layer_kinds()
        self.n_moe_layers = sum(1 for _, f in kinds if f == MOE)
        self.n_dense_layers = len(kinds) - self.n_moe_layers

        if cfg.mla is not None:
            m = cfg.mla
            H = cfg.num_heads
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            self.attn_params = (
                d * m.q_lora_rank + m.q_lora_rank * H * qk
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + 2 * m.kv_lora_rank * H * m.qk_nope_head_dim
                + H * m.v_head_dim * d)
            # latent attention: scores against [ckv;krope], ctx over ckv
            self.attn_flops_per_ctx_tok = 2.0 * H * (
                2 * m.kv_lora_rank + m.qk_rope_head_dim)
            self.kv_bytes_per_token = (
                m.kv_lora_rank + m.qk_rope_head_dim) * 2.0
        else:
            hd = cfg.resolved_head_dim
            self.attn_params = d * (cfg.num_heads
                                    + 2 * cfg.num_kv_heads) * hd \
                + cfg.num_heads * hd * d
            self.attn_flops_per_ctx_tok = 2.0 * cfg.num_kv_heads * hd * 2
            self.kv_bytes_per_token = 2.0 * cfg.num_kv_heads * hd * 2

        e = cfg.moe
        self.moe_flops_per_token = (
            6.0 * d * e.expert_d_ff * max(e.top_k, 1)
            + 6.0 * d * (e.shared_d_ff or e.expert_d_ff)
            * e.num_shared_experts) if e.enabled else 0.0
        # one routed expert's weights, int8 (§4.1 W8A8): what an EPLB
        # replica migration moves per (layer, expert) load
        self.expert_weight_bytes = int(3.0 * d * e.expert_d_ff) \
            if e.enabled else 0
        # int8-quantized expert weights streamed from HBM every iteration
        self.moe_weight_bytes_per_die = (
            3.0 * d * e.expert_d_ff
            * max(1.0, e.num_experts / max(self.plan.n_expert, 1))
            if e.enabled else 0.0)
        self.dense_ffn_flops_per_token = 6.0 * d * cfg.d_ff
        self.active_params = cfg.active_param_count()

    # ------------------------------------------------------------------
    def prefill_time(self, n_tokens: int, n_dies: int = 8,
                     slowdown: float = 1.0) -> float:
        """Monolithic prefill of one whole prompt over a TP group of
        dies (legacy entry — the chunked path prices per-chunk via
        :meth:`prefill_chunk_time`)."""
        flops = 2.0 * self.active_params * max(n_tokens, 1)
        t = flops / (n_dies * PEAK_FLOPS * self.prefill_mfu)
        return (t + 2e-3) * slowdown

    def prefill_chunk_time(self, chunk_tokens: int, context: int = 0,
                           n_dies: int = 8, slowdown: float = 1.0
                           ) -> float:
        """One prefill CHUNK of ``chunk_tokens`` tokens at prompt offset
        ``context`` over a TP group of dies.

        The dense-GEMM term is linear in the chunk; the attention term
        grows with the context the chunk attends over (earlier chunks'
        KV), so late chunks of a long prompt genuinely cost more — the
        §7.2 long-context regime the dedicated TE pools exist for. A
        measured ``prefill/chunk_time/c<N>`` calibration curve replaces
        the dense term; the context term stays analytic (the calibration
        bench measures fixed-offset chunks). Fixed per-chunk overhead
        ``prefill_chunk_overhead`` is the cost of slicing."""
        n = max(chunk_tokens, 1)
        if self._calib_prefill:
            xs = [c[0] for c in self._calib_prefill]
            t = float(np.interp(n, xs,
                                [c[1] for c in self._calib_prefill]))
        else:
            flops = 2.0 * self.active_params * n
            t = flops / (n_dies * PEAK_FLOPS * self.prefill_mfu)
        n_layers = self.n_moe_layers + self.n_dense_layers
        ctx_flops = (n * (context + n / 2.0)
                     * self.attn_flops_per_ctx_tok * n_layers)
        t += ctx_flops / (n_dies * PEAK_FLOPS * self.prefill_mfu)
        return (t + self.prefill_chunk_overhead) * slowdown

    def kv_transfer_time(self, n_tokens: int, src_pod: int = 0,
                         dst_pod: int = 0) -> float:
        """PD KV move of one request's prefilled context (per layer ×
        layers, batched into one DistFlow task). Cross-pod paths price
        over the topology's scale-out link (RoCE) instead of UB."""
        total = n_tokens * self.kv_bytes_per_token * (
            self.n_moe_layers + self.n_dense_layers)
        return self.fabric.transfer_time(int(total), src_pod, dst_pod)

    # ------------------------------------------------------------------
    def _attn_time(self, b: float, ctx: float,
                   weight_amort: float = 1.0) -> float:
        """Attention term (per attention die, per layer): weight read +
        KV sweep vs projection/attend FLOPs — roofline max.

        ``weight_amort`` > 1 spreads the weight read across that many
        microbatches (the parameters stream from HBM once per layer; the
        per-microbatch KV sweep and FLOPs still scale with ``b``)."""
        attn_comp = b * (2.0 * self.attn_params
                         + ctx * self.attn_flops_per_ctx_tok) \
            / (PEAK_FLOPS * self.decode_mfu)
        attn_mem = (self.attn_params * 2.0 / weight_amort
                    + b * ctx * self.kv_bytes_per_token) \
            / (HBM_BW * self.hbm_eff)
        return max(attn_comp, attn_mem)

    def _dense_ffn_time(self, b: float) -> float:
        """Dense-FFN term (per die, per dense layer): FFN GEMM FLOPs vs
        the bf16 weight stream — shared by both deployments' pricing so
        their dense layers cannot drift apart."""
        return max(b * self.dense_ffn_flops_per_token
                   / (PEAK_FLOPS * self.decode_mfu),
                   3.0 * self.cfg.d_model * self.cfg.d_ff * 2.0
                   / (HBM_BW * self.hbm_eff))

    def _moe_time(self, b: float, moe_imbalance: float,
                  weight_amort: float = 1.0) -> float:
        e = self.cfg.moe
        global_tokens = b * max(self.plan.n_attention, 1)
        tokens_per_exp_die = global_tokens * e.top_k / self.plan.n_expert
        moe_comp = (tokens_per_exp_die * moe_imbalance
                    * self.moe_flops_per_token / max(e.top_k, 1)) \
            / (PEAK_FLOPS * self.decode_mfu * self.int8_moe_speedup)
        moe_mem = self.moe_weight_bytes_per_die / weight_amort \
            / (HBM_BW * self.hbm_eff)
        return max(moe_comp, moe_mem)

    @staticmethod
    def _pingpong_layer_time(mb: int, t_attn: float, t_disp: float,
                             t_moe: float, t_comb: float) -> float:
        """§4.4 ping-pong: ``mb`` microbatches alternate between the
        compute streams (attention die, expert die) and the
        communication engines (dispatch/combine run on SDMA/MTE streams
        concurrently with compute, the §5.2 persistent-kernel model).
        Compute runs back to back — each microbatch's dispatch+combine
        hides under the other microbatches' compute — and only the
        communication that exceeds that shadow stays exposed (the
        fill/drain of the last microbatch). Inputs are per-microbatch
        stage times; returns the layer time."""
        compute_mb = t_attn + t_moe
        comm_mb = t_disp + t_comb
        exposed = max(0.0, comm_mb - (mb - 1) * compute_mb)
        return mb * compute_mb + exposed

    def reconfig_transfer_time(self, n_replica_loads: int) -> float:
        """Fabric time for an EPLB weight migration critical path:
        ``n_replica_loads`` expert replicas (int8 weights) streamed into
        one NPU's HBM over the UB fabric (§4.5 step 3 — prefetch and
        shadow-load each pay this)."""
        if n_replica_loads <= 0 or self.expert_weight_bytes <= 0:
            return 0.0
        return self.fabric.transfer_time(
            n_replica_loads * self.expert_weight_bytes)

    def decode_iter_time(self, batch_per_die: int, mean_context: int = 0,
                         moe_imbalance=1.0,
                         slowdown: float = 1.0,
                         microbatches: Optional[int] = None,
                         mtp_k: int = 0,
                         placement_slots: int = 0) -> float:
        """One decode iteration of a DP group (batch ``batch_per_die``
        per attention die), with the pod's other DP domains loading the
        shared expert dies symmetrically.

        moe_imbalance ≥ 1: hottest-expert-die load over the mean (from
        live expert counts + the active EPLB map); the hottest die sets
        the all-to-all critical path. A SEQUENCE of m values prices the
        MoE layers per layer: each entry stands for ``n_moe_layers / m``
        consecutive layers at that entry's imbalance (the simulator's
        folded per-layer EPLB view) — a hot expert in ONE layer then
        lengthens the iteration by exactly that layer group's share.

        ``microbatches`` overrides the plan's microbatch count: ≥ 2
        prices the §4.4 ping-pong overlap (per-microbatch stage times at
        ``b / mb``, dispatch/combine hidden under the other microbatch's
        expert GMM); 1 prices the serial attn→dispatch→MoE→combine
        chain.

        ``mtp_k`` ≥ 1 prices §4.6 propose-then-verify inside the
        iteration: the fused verify chain re-runs the token-dependent
        work over ``k + 1`` tokens per slot — modeled as the iteration
        at effective batch ``b·(k+1)`` (weights stay resident: the
        memory-bound side amortizes, exactly what makes speculative
        decoding pay at decode batch sizes) — plus ``k`` draft-head
        passes (measured ``mtp/draft_overhead`` row when calibrated, an
        analytic one-block time otherwise). The emitted tokens per
        iteration (1 + accepted drafts) are the engine's concern; this
        method prices only the iteration itself.

        ``placement_slots`` ≥ 1 marks the iteration placement-active
        (an EPLB table with that many physical slots is installed): each
        MoE layer then pays the placement term — the measured
        ``eplb/placement_gmm`` residual when calibrated; otherwise zero
        on the gather-free owner-indexed GMM path
        (``placement_gather_free``, the default — replica routing is
        free at the kernel level), or the legacy owner-gathered HBM
        traffic (the [n_phys, d, f] weight materialization written and
        re-read every step) when ``placement_gather_free`` is False.
        """
        if batch_per_die <= 0:
            return self.iter_overhead
        if mtp_k > 0:
            base = self.decode_iter_time(
                batch_per_die * (mtp_k + 1), mean_context=mean_context,
                moe_imbalance=moe_imbalance, microbatches=microbatches,
                placement_slots=placement_slots)
            ctx = mean_context or self.mean_context
            if self.mtp_draft_overhead is not None:
                t_draft = mtp_k * self.mtp_draft_overhead
            else:
                # one transformer-block-ish pass per draft: attention at
                # the REAL batch (the draft head decodes one token per
                # slot) plus a dense FFN-scale projection
                t_draft = mtp_k * (self._attn_time(batch_per_die, ctx)
                                   + self._dense_ffn_time(batch_per_die))
            return (base + t_draft) * slowdown
        plan = self.plan
        ctx = mean_context or self.mean_context
        b = batch_per_die
        mb = plan.microbatches if microbatches is None else microbatches
        mb = max(int(mb), 1)

        t_attn = self._attn_time(b, ctx)

        e = self.cfg.moe
        if e.enabled and plan.n_expert > 0:
            if mb >= 2:
                # per-microbatch stage times at b/mb; the fixed metadata
                # fan-out of dispatch/combine is paid per microbatch
                b_mb = b / mb
                t_disp, t_comb = self._comm_times(b_mb)
                t_attn_mb = self._attn_time(b_mb, ctx, weight_amort=mb)

                def layer_time(imb: float) -> float:
                    return self._pingpong_layer_time(
                        mb, t_attn_mb, t_disp,
                        self._moe_time(b_mb, imb, weight_amort=mb),
                        t_comb) + 2e-6
            else:
                t_disp, t_comb = self._comm_times(b)

                def layer_time(imb: float) -> float:
                    return (t_attn + self._moe_time(b, imb)
                            + t_disp + t_comb)

            if isinstance(moe_imbalance, (list, tuple, np.ndarray)):
                imbs = [float(v) for v in np.asarray(moe_imbalance).ravel()]
                t_moe_total = (sum(layer_time(v) for v in imbs)
                               * (self.n_moe_layers / max(len(imbs), 1)))
            else:
                t_moe_total = self.n_moe_layers \
                    * layer_time(float(moe_imbalance))
            if placement_slots > 0:
                if self.placement_gmm_overhead is not None:
                    t_place = self.placement_gmm_overhead
                elif not self.placement_gather_free:
                    # owner-gathered baseline: [n_phys, d, f] int8
                    # weights written then re-read by the GMM — pure
                    # HBM traffic per placement-active MoE layer
                    t_place = (2.0 * placement_slots
                               * self.expert_weight_bytes
                               / (HBM_BW * self.hbm_eff))
                else:
                    t_place = 0.0
                if t_place:
                    t_moe_total += self.n_moe_layers * t_place
        else:
            t_moe_total = self.n_moe_layers * t_attn

        t_dense = t_attn + self._dense_ffn_time(b)

        t_iter = (t_moe_total
                  + self.n_dense_layers * t_dense
                  + self.iter_overhead)
        return t_iter * slowdown

    # ------------------------------------------------------------------
    # MoE-Attention disaggregated deployment (§5.2, SimConfig.deployment
    # = "moe_attn"): stage-level pricing through the DomainPipeline
    # closed form instead of the per-die serial layer chain above
    # ------------------------------------------------------------------
    def moe_attn_stage_times(self, batch_per_die: float,
                             mean_context: int = 0,
                             moe_imbalance: float = 1.0,
                             microbatches: Optional[int] = None):
        """Per-(domain, microbatch) :class:`StageTimes` of the §5.2
        pipeline at this plan: attention-die compute, A2E trampoline
        latency (measured dispatch curve when calibrated, analytic
        ``a2e_latency_model`` otherwise), expert-die MoE compute for ONE
        domain's microbatch, E2A return."""
        from repro_torch.core.moe_attn_disagg import StageTimes
        plan = self.plan
        ctx = mean_context or self.mean_context
        mb = plan.microbatches if microbatches is None else microbatches
        mb = max(int(mb), 1)
        b_mb = batch_per_die / mb
        t_attn = self._attn_time(b_mb, ctx, weight_amort=mb)
        t_a2e, t_e2a = self._comm_times(b_mb)
        return StageTimes(t_attn, t_a2e,
                          self._moe_stage_time(b_mb, moe_imbalance, mb),
                          t_e2a)

    def _moe_stage_time(self, b_mb: float, imb: float, mb: int) -> float:
        """Expert-pool time for ONE (domain, microbatch) visit: the
        tokens of one domain's attention dies, spread over the whole
        expert pool (cf. :meth:`_moe_time`, which prices all domains'
        tokens at once for the colocated serial chain). Expert weights
        stream from HBM once per layer, amortized over the layer's
        ``nd·mb`` visits; every visit pays the fixed launch/doorbell
        overhead the colocated path fuses away."""
        e = self.cfg.moe
        plan = self.plan
        nd = max(plan.n_dp_domains, 1)
        tokens_per_exp_die = (b_mb * plan.dp_groups_per_domain * e.top_k
                              / max(plan.n_expert, 1))
        comp = (tokens_per_exp_die * imb * self.moe_flops_per_token
                / max(e.top_k, 1)) \
            / (PEAK_FLOPS * self.decode_mfu * self.int8_moe_speedup)
        mem = self.moe_weight_bytes_per_die / (nd * mb) \
            / (HBM_BW * self.hbm_eff)
        return max(comp, mem) + self.expert_op_overhead

    def moe_attn_pipeline(self, times, n_layers: Optional[int] = None):
        """The pricing seam: run the closed-form
        :meth:`~repro_torch.core.moe_attn_disagg.DomainPipeline.steady_state`
        over ``times`` (one :class:`StageTimes` or a per-layer sequence)
        at this plan. ``DomainPipeline.schedule()`` on the same inputs
        is the discrete reference the tests cross-validate against."""
        from repro_torch.core.moe_attn_disagg import DomainPipeline
        return DomainPipeline(
            self.plan, times,
            self.n_moe_layers if n_layers is None else n_layers
        ).steady_state()

    def moe_attn_decode_iter_time(self, batch_per_die: int,
                                  mean_context: int = 0,
                                  moe_imbalance=1.0,
                                  slowdown: float = 1.0,
                                  expert_slowdown: float = 1.0,
                                  microbatches: Optional[int] = None,
                                  attn_stage_slowdown: Optional[float]
                                  = None) -> MoEAttnIterCost:
        """One decode iteration of an attention-pool DP group under the
        MoE-Attention disaggregated deployment.

        The MoE layers run through the DP-domain pipeline closed form
        (expert pool shared by all domains, A2E/E2A trampoline latency
        on every microbatch chain); dense layers and the per-iteration
        overhead stay on the attention pool exactly as in
        :meth:`decode_iter_time`. ``moe_imbalance`` follows the same
        scalar-or-per-layer-sequence folding contract;
        ``expert_slowdown`` scales every layer's expert stage (a hot or
        degraded expert-pool die gates ALL attention DPs — pool-aware
        fault injection), while ``slowdown`` is this DP's own
        attention-die factor (it scales the attention-side terms: dense
        layers, iteration overhead, and — by default — the pipeline's
        attention stage).

        ``attn_stage_slowdown`` overrides the factor applied to the
        PIPELINE's attention stage alone: the §5.2 schedule time-
        multiplexes a whole DP DOMAIN through each expert-stage slot, so
        a straggling attention die gates the pipeline of every
        domain-mate — the simulator passes the domain's max die slowdown
        here while ``slowdown`` stays this die's own factor (per-DOMAIN
        fault targeting)."""
        if batch_per_die <= 0:
            return MoEAttnIterCost(self.iter_overhead, 0.0, 0.0, 0.0,
                                   0.0, 0, 0)
        ctx = mean_context or self.mean_context
        b = batch_per_die
        if isinstance(moe_imbalance, (list, tuple, np.ndarray)):
            imbs = [float(v) for v in np.asarray(moe_imbalance).ravel()]
        else:
            imbs = [float(moe_imbalance)]
        attn_sl = (slowdown if attn_stage_slowdown is None
                   else attn_stage_slowdown)
        distinct = [
            self.moe_attn_stage_times(b, ctx, v, microbatches)
            .scaled(attn=attn_sl, moe=expert_slowdown) for v in imbs]
        L = max(self.n_moe_layers, 1)
        m = len(distinct)
        # folded per-layer view: entry g covers layers [g·L/m, (g+1)·L/m)
        times = [distinct[min(layer * m // L, m - 1)]
                 for layer in range(self.n_moe_layers)]
        rep = self.moe_attn_pipeline(times)
        t_pipe = rep.iteration_time

        t_dense = self._attn_time(b, ctx) + self._dense_ffn_time(b)
        t_iter = (t_pipe
                  + (self.n_dense_layers * t_dense + self.iter_overhead)
                  * slowdown)

        e = self.cfg.moe
        d = self.cfg.d_model
        n_assign = b * max(e.top_k, 1) * self.n_moe_layers
        return MoEAttnIterCost(
            t_iter=t_iter,
            t_pipeline=t_pipe,
            attn_busy_frac=rep.attention_busy,
            expert_busy_frac=rep.expert_busy,
            bubble_frac=max(0.0, 1.0 - rep.expert_busy),
            a2e_bytes=int(n_assign * (d + 4)),   # int8 rows + fp32 scale
            e2a_bytes=int(n_assign * d * 2))     # bf16 combine payload


# ---------------------------------------------------------------------------
# Execution stub: deterministic pseudo-model on the cost model
# ---------------------------------------------------------------------------
class CostModelBackend(ExecutionBackend):
    """No-tensor backend for simulated DP groups.

    Logits are a pure hash of (last token, position) so decoding is
    byte-deterministic; forward "latency" is accounted virtually by the
    sim engine via the cost model (this class only counts invocations).
    """

    SIM_VOCAB = 64
    supports_chunked_prefill = True

    def __init__(self, dp_id: int, cost: SuperPodCostModel,
                 mtp_k: int = 0):
        self.dp_id = dp_id
        self.cost = cost
        self.mtp_k = int(mtp_k)
        self.vocab_size = self.SIM_VOCAB
        self.n_prefills = 0
        self.n_decode_steps = 0
        self.n_prefill_chunks = 0
        self.n_prefill_seeds = 0
        # EPLB data plane (apply_placement contract): the active
        # PlacementTable and how many swaps this die has taken
        self.placement = None
        self.n_placement_swaps = 0

    def apply_placement(self, table) -> None:
        """Install the swapped-in placement (the sim prices the routing
        effect through the engine's per-layer imbalance; the backend
        records the swap so tests can assert the contract fired)."""
        self.placement = table
        self.n_placement_swaps += 1

    def init_cache(self, max_batch: int, max_len: int):
        return {"sim_dp": self.dp_id, "slots": max_batch}

    def prefill(self, tokens: List[int]) -> Tuple[dict, np.ndarray]:
        self.n_prefills += 1
        v = self.vocab_size
        nxt = (sum(tokens) * 31 + len(tokens) * 7 + 13) % v
        logits = np.zeros((v,), np.float32)
        logits[nxt] = 1.0
        return {"sim_dp": self.dp_id, "prefill_len": len(tokens)}, logits

    def prefill_chunk(self, cache, tokens: List[int], offset: int,
                      total_len: int):
        """Chunk-counting implementation of the ``prefill_chunk``
        contract: accumulates the deterministic token hash so the final
        chunk's logits equal :meth:`prefill`'s for the whole prompt."""
        self.n_prefill_chunks += 1
        if cache is None:
            if offset != 0:
                raise ValueError("first chunk must start at offset 0")
            cache = {"sim_dp": self.dp_id, "prefill_len": 0,
                     "tok_sum": 0}
        if offset != cache["prefill_len"]:
            raise ValueError(
                f"non-contiguous chunk: offset {offset} != "
                f"{cache['prefill_len']}")
        cache = dict(cache)
        cache["tok_sum"] += sum(tokens)
        cache["prefill_len"] += len(tokens)
        if cache["prefill_len"] < total_len:
            return cache, None
        v = self.vocab_size
        nxt = (cache["tok_sum"] * 31 + cache["prefill_len"] * 7 + 13) % v
        logits = np.zeros((v,), np.float32)
        logits[nxt] = 1.0
        return cache, logits

    # prefix-KV contract: the "KV" of a token range is just its token
    # sum, so a seeded cache continues the hash accumulation exactly
    # where a cold prefill of the same prefix would be — hit-seeded and
    # cold prefill emit identical logits by construction
    supports_prefix_kv = True

    def slice_prefill_kv(self, cache, tokens: List[int], start: int,
                         end: int) -> dict:
        return {"tok_sum": int(sum(tokens[start:end])), "n": end - start}

    def seed_prefill_cache(self, payloads: List[dict], prefix_len: int,
                           total_len: int) -> dict:
        self.n_prefill_seeds += 1
        return {"sim_dp": self.dp_id, "prefill_len": prefix_len,
                "tok_sum": int(sum(p["tok_sum"] for p in payloads))}

    def write_slot(self, cache, cache1, slot: int):
        return cache

    def _next_tokens(self, tokens: np.ndarray,
                     positions: np.ndarray) -> np.ndarray:
        v = self.vocab_size
        return ((tokens[:, 0].astype(np.int64) * 5
                 + positions.astype(np.int64) * 3 + 11) % v)

    def decode(self, cache, tokens: np.ndarray,
               positions: np.ndarray) -> Tuple[np.ndarray, dict]:
        self.n_decode_steps += 1
        b = tokens.shape[0]
        nxt = self._next_tokens(tokens, positions)
        logits = np.zeros((b, self.vocab_size), np.float32)
        logits[np.arange(b), nxt] = 1.0
        return logits, cache

    def decode_sample(self, cache, tokens: np.ndarray,
                      positions: np.ndarray, temperatures: np.ndarray,
                      step: int, *, donate: bool = True):
        """Fast-path contract: [B] int32 tokens, never a logits plane.

        Greedy slots take the deterministic pseudo-argmax; sampled slots
        draw Gumbel noise from a generator seeded purely by
        ``(dp_id, step)`` so simulated traces stay byte-reproducible.
        """
        self.n_decode_steps += 1
        nxt = self._next_tokens(tokens, positions).astype(np.int32)
        temps = np.asarray(temperatures, np.float32)
        if np.any(temps > 0):
            rng = np.random.default_rng((self.dp_id, int(step)))
            g = rng.gumbel(size=(temps.shape[0], self.vocab_size))
            onehot = np.zeros_like(g)
            onehot[np.arange(len(nxt)), nxt] = 1.0
            stoch = np.argmax(
                onehot / np.maximum(temps, 1e-6)[:, None] + g,
                axis=-1).astype(np.int32)
            nxt = np.where(temps > 0, stoch, nxt)
        return nxt, cache

    def init_mtp_cache(self, max_batch: int, max_len: int):
        return {"sim_dp": self.dp_id, "mtp_slots": max_batch}

    def reset_mtp_slot(self, mtp_cache, slot: int):
        return mtp_cache

    def decode_sample_mtp(self, cache, mtp_cache, tokens: np.ndarray,
                          positions: np.ndarray,
                          temperatures: np.ndarray, step: int, *,
                          donate: bool = True):
        """``decode_sample_mtp`` contract on the pseudo-model: the token
        block chains the SAME deterministic hash the 1-token path steps
        through, so for greedy slots the emitted stream is exactly what
        ``decode_sample`` would produce over n_acc+1 iterations (the
        sim's analogue of the served path's lossless greedy acceptance);
        stochastic slots chain per-position Gumbel draws seeded by
        ``(dp_id, step)``. Accepted lengths are the leading run of
        Bernoulli(``cost.mtp_acceptance``) successes, drawn from a
        generator seeded purely by ``(dp_id, step, salt)`` so traces
        stay byte-reproducible.
        """
        if not self.mtp_k:
            raise NotImplementedError("backend built with mtp_k=0")
        self.n_decode_steps += 1
        k = self.mtp_k
        B = tokens.shape[0]
        temps = np.asarray(temperatures, np.float32)
        stoch_rng = (np.random.default_rng((self.dp_id, int(step)))
                     if np.any(temps > 0) else None)
        block = np.zeros((B, k + 1), np.int32)
        tok = np.asarray(tokens, np.int64)[:, 0]
        pos = np.asarray(positions, np.int64)
        for j in range(k + 1):
            nxt = ((tok * 5 + (pos + j) * 3 + 11)
                   % self.vocab_size).astype(np.int32)
            if stoch_rng is not None:
                g = stoch_rng.gumbel(size=(B, self.vocab_size))
                onehot = np.zeros_like(g)
                onehot[np.arange(B), nxt] = 1.0
                stoch = np.argmax(
                    onehot / np.maximum(temps, 1e-6)[:, None] + g,
                    axis=-1).astype(np.int32)
                nxt = np.where(temps > 0, stoch, nxt)
            block[:, j] = nxt
            tok = nxt.astype(np.int64)
        acc_rng = np.random.default_rng((self.dp_id, int(step), 7919))
        acc = (acc_rng.random((B, k))
               < self.cost.mtp_acceptance).astype(np.int32)
        n_acc = np.cumprod(acc, axis=1).sum(axis=1).astype(np.int32)
        return block, n_acc, cache, mtp_cache
