"""Disaggregated MoE-Attention (§5.2).

Attention dies run MLAProlog/attention/gating/output-projection + A2E/E2A;
expert dies run only A2E → expert FFN → E2A, kept busy by time-multiplexing
*DP domains* (inter-DP parallelism) on top of microbatching (intra-DP
parallelism), with trampoline-forward routing absorbing the asymmetric
rank counts (§3.3).

Three layers here:

* **Functional split** — ``attention_half`` / ``expert_half`` /
  ``combine_half``: the per-layer computation factored so that the two
  halves exchange only the A2E/E2A payloads. Packing runs the
  route-pack kernel (with its INT8 branch as the A2E wire format), the
  expert half the grouped-FFN kernel (owner-indexed under an EPLB
  placement), and the attention half, for GQA layers, the
  decode-attention kernel. Their composition matches the monolithic
  decode step (tests).

* **DP-domain pipeline** — :class:`DomainPipeline` drives domains ×
  microbatches through the expert stage in the Fig. 19 schedule and
  reports modeled utilization. :func:`paper_stage_times` holds the
  paper's Ascend 910C §7.1 stage times; times measured on another
  device are passed in as a :class:`StageTimes` of their own.

* **Zero-overhead scheduling** — the paper's persistent kernels (3
  streams polling A2E/MoE/E2A without CPU returns) map to stage
  functions whose kernels are queued on the CUDA stream without a host
  sync anywhere in a decode step: the host only blocks where the caller
  reads the logits back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.configs.base import MOE, ModelConfig
from repro_torch.core.transformerless import PartitionPlan
from repro_torch.kernels.gmm.ops import expert_ffn
from repro_torch.kernels.route_pack.ops import (fused_route_pack,
                                                placement_route)
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models.common import microbatch_sizes, rms_norm
from repro_torch.models.transformer import Model, _index, block_apply
from repro_torch.xccl.routing import dequantize_tokens

PyTree = Any


# ===========================================================================
# Functional split of one MoE layer
# ===========================================================================
def attention_half(block_params, x, *, cfg: ModelConfig, cache, positions):
    """Attention-die computation: mixer + residual + FFN-norm + router
    logits + (shared experts, which the paper co-locates with attention
    gating on the attention side for DeepSeek). The mixer runs in decode
    mode and writes the new token's KV into ``cache`` in place. Returns
    the hidden state to dispatch and everything needed to combine."""
    mixer = block_params["mixer"]
    apply = A.mla_apply if "wq_a" in mixer else A.attn_apply
    h = rms_norm(x, block_params["mixer_norm"], cfg.norm_eps)
    y, new_cache = apply(mixer, h, cfg=cfg, mode="decode", cache=cache,
                         positions=positions)
    x = x + y
    hn = rms_norm(x, block_params["ffn_norm"], cfg.norm_eps)
    B, S, d = hn.shape
    idx, w, _, _ = F._route(hn.reshape(B * S, d),
                            block_params["ffn"]["router"], cfg.moe.top_k)
    ffn = block_params["ffn"]
    shared = (F.mlp_apply(ffn["shared"], hn) if "shared" in ffn
              else torch.zeros_like(hn))
    return x, hn, idx, w, shared, new_cache


def expert_half(ffn_params, buckets: torch.Tensor,
                phys_owner: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Expert-die computation: the routed expert FFN on capacity buckets
    [E, C, d] (A2E delivers them; E2A takes the result back), in the
    buckets' dtype.

    ``phys_owner`` [n_phys] activates EPLB placement: buckets are per
    *physical replica slot* and each slot computes with its owning
    logical expert's weights, read in place by the owner-indexed grouped
    FFN (no gathered copy of the weights)."""
    out = expert_ffn(buckets, ffn_params["we_gate"], ffn_params["we_up"],
                     ffn_params["we_down"], phys_owner=phys_owner)
    return out.to(buckets.dtype)


def combine_half(x, routed_out, shared_out):
    """Attention-die combine: weighted routed output (+ shared experts)
    back into the residual stream."""
    return x + routed_out.to(x.dtype) + shared_out.to(x.dtype)


def chunk_cap(n_tokens: int, n_dest: int, top_k: int,
              capacity_factor: float) -> int:
    """Per-destination bucket capacity for one A2E chunk.

    ``n_tokens * top_k`` assignments spread over ``n_dest`` buckets,
    headroom ``capacity_factor``, floored at 4 so tiny chunks keep a
    usable bucket. Tokens beyond a bucket's capacity are dropped by the
    FIFO capacity rank — the overflow count per destination is exactly
    ``max(0, count(dest) - capacity)``."""
    return max(int(n_tokens * top_k / max(n_dest, 1) * capacity_factor),
               4)


def pack_dispatch(hn, idx, w, n_experts: int, capacity: int,
                  quantize: bool = True, placement=None):
    """A2E payload packing on the attention die: one fused route-pack
    launch (capacity rank + INT8 wire quantization + bucket scatter).

    ``placement`` = (replica_slots [E, R], n_replicas [E]) remaps the
    logical routed ids to EPLB physical replica slots (round-robin of
    token position) BEFORE packing — ``n_experts`` must then be the
    physical slot count and the expert half runs owner-indexed
    (:func:`expert_half` with ``phys_owner``). With ``quantize`` the
    expert half receives the int8 rows and per-row scales dequantized to
    ``hn``'s dtype. Returns (buckets [n_experts, capacity, d], state)."""
    B, S, d = hn.shape
    hf = hn.reshape(B * S, d)
    k = idx.shape[-1]
    n = B * S * k
    flat_idx = idx.reshape(n).to(torch.int32)
    tok_of = torch.arange(n, device=hn.device) // k
    if placement is not None:
        flat_idx = placement_route(flat_idx, tok_of, placement[0],
                                   placement[1])
    pack = fused_route_pack(hf, flat_idx, k=k, n_dest=n_experts,
                            capacity=capacity, quantize=quantize)
    if quantize:
        # the expert half consumes dequantized activations (the wire —
        # A2E on hardware — carries the int8 + scales form)
        buckets = dequantize_tokens(
            pack.buckets.reshape(-1, d),
            pack.scales.reshape(-1)).reshape(
            n_experts, capacity, d).to(hn.dtype)
    else:
        buckets = pack.buckets
    state = (flat_idx, pack.rank, pack.keep, tok_of, w.reshape(n))
    return buckets, state


def unpack_combine(expert_out, state, n_tokens: int, d: int, capacity: int):
    """E2A unpacking + weighted sum on the attention die → [n_tokens, d]
    f32. Each token's k weighted rows are added in index order
    (``ffn.combine_assignments``), never with ``index_add_``, whose
    atomics add in any order on the card: a repeated step is
    bit-identical."""
    flat_idx, rank, keep, _, flat_w = state
    y = expert_out[flat_idx.long(), rank.long().clamp(0, capacity - 1)]
    y = torch.where(keep[:, None], y.float(),
                    torch.zeros((), device=y.device))
    return F.combine_assignments(y * flat_w[:, None],
                                 flat_idx.shape[0] // n_tokens)


# ===========================================================================
# The disaggregated decode driver (functional simulation)
# ===========================================================================
class DisaggregatedMoEAttention:
    """Runs a MoE model's decode with attention and expert halves as
    separate stages exchanging A2E/E2A payloads, on the device that
    holds ``params``. Its KV equals the monolithic ``Model.decode_step``'s
    where no MoE layer feeds a later attention layer, and its logits
    match up to the combine's add order (tests)."""

    def __init__(self, model: Model, params: PyTree,
                 capacity_factor: float = 8.0, quantize: bool = False,
                 microbatches: int = 1, placement=None):
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.quantize = quantize
        self.capacity_factor = capacity_factor
        # §4.4 ping-pong: split the decode batch so the A2E/E2A of one
        # micro-batch overlaps the expert GMM of the other (each stage is
        # queued on the stream; the host never syncs between)
        self.microbatches = max(1, int(microbatches))
        # EPLB data plane: a PlacementTable routes each layer's A2E
        # payload to physical replica slots; the expert stage computes
        # redundant slots with their owners' weights
        self.placement = placement

    # -- per-layer views ------------------------------------------------------
    def _block_params(self, layer_i: int):
        """(layer ``layer_i``'s parameters, its location): the stacked
        superblock leaves are indexed as views, never copied."""
        cfg = self.cfg
        np_ = len(cfg.prefix_layers)
        if layer_i < np_:
            return self.params["prefix"][layer_i], ("prefix", layer_i)
        sb, pos = divmod(layer_i - np_, cfg.pattern_len)
        return (_index(self.params["blocks"][f"pos{pos}"], sb),
                ("blocks", sb, pos))

    @staticmethod
    def _layer_cache(cache: PyTree, loc):
        """The layer's cache leaves as views of ``cache``: the mixer's
        in-place writes land in the caller's cache."""
        if loc[0] == "prefix":
            return cache["prefix"][loc[1]]
        return _index(cache["blocks"][f"pos{loc[2]}"], loc[1])

    def moe_layer(self, layer_i: int, params_layer, x, cache, positions):
        """One MoE layer split into its stages: the attention half, then
        per micro-batch pack/A2E and the expert half, then E2A and the
        combine. Returns the layer's output [B, S, d]."""
        e = self.cfg.moe
        B, S, d = x.shape
        x, hn, idx, w, shared, _ = attention_half(
            params_layer, x, cfg=self.cfg, cache=cache, positions=positions)
        lp = (None if self.placement is None
              else self.placement.layer(layer_i))
        n_dest = e.num_experts if lp is None else int(lp[2].shape[0])
        owner = None if lp is None else lp[2]
        # §4.4 ping-pong over micro-batches: the pack of micro-batch m+1
        # is queued while the expert stage of micro-batch m may still run
        pending, off = [], 0
        for sz in microbatch_sizes(B, self.microbatches):
            cap = chunk_cap(sz * S, n_dest, e.top_k, self.capacity_factor)
            buckets, state = pack_dispatch(
                hn[off:off + sz], idx[off * S:(off + sz) * S],
                w[off * S:(off + sz) * S], n_dest, cap, self.quantize,
                placement=None if lp is None else (lp[0], lp[1]))
            # A2E (trampoline two-stage on hardware) → experts
            out_b = expert_half(params_layer["ffn"], buckets, owner)
            pending.append((out_b, state, sz, cap))
            off += sz
        # E2A → back on the attention die
        routed = torch.cat([unpack_combine(o, st, sz * S, d, cap)
                            .reshape(sz, S, d)
                            for o, st, sz, cap in pending], dim=0)
        return combine_half(x, routed, shared)

    # -- full decode step -----------------------------------------------------
    def decode_step(self, cache: PyTree, tokens, positions):
        """tokens [B, 1]; positions [B] → (logits [B, V] f32, cache). The
        new token's KV is written into ``cache`` in place, as
        ``Model.decode_step`` writes it."""
        cfg = self.cfg
        x = self.model._embed(self.params, tokens)
        for layer_i, kind in enumerate(cfg.layer_kinds()):
            params_layer, loc = self._block_params(layer_i)
            c = self._layer_cache(cache, loc)
            if kind[1] == MOE:
                x = self.moe_layer(layer_i, params_layer, x, c, positions)
            else:
                x, _, _ = block_apply(params_layer, x, cfg=cfg, kind=kind,
                                      mode="decode", cache=c,
                                      positions=positions)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        return self.model._logits(self.params, x[:, -1]), cache


# ===========================================================================
# DP-domain pipeline model (Fig. 19)
# ===========================================================================
@dataclasses.dataclass
class StageTimes:
    t_attn: float       # attention compute per microbatch per layer
    t_a2e: float
    t_moe: float
    t_e2a: float

    def scaled(self, *, attn: float = 1.0, a2e: float = 1.0,
               moe: float = 1.0, e2a: float = 1.0) -> "StageTimes":
        """Per-stage scaling (EPLB imbalance inflates ``moe``; an
        expert-pool straggler inflates ``moe``; a slow attention die
        inflates ``attn``)."""
        return StageTimes(self.t_attn * attn, self.t_a2e * a2e,
                          self.t_moe * moe, self.t_e2a * e2a)


@dataclasses.dataclass
class PipelineReport:
    iteration_time: float
    expert_busy: float          # fraction of time expert dies are busy
    attention_busy: float
    timeline: List[Tuple[str, int, int, float, float]]  # (stage, dom, mb, t0, t1)


class DomainPipeline:
    """Steady-state schedule: only one DP domain talks to the expert dies
    at a time (A2E/MoE/E2A occupy the expert stage); a domain's attention
    for microbatch m+1 overlaps other domains' expert phases.

    ``times`` is either one :class:`StageTimes` (uniform layers) or a
    sequence of ``n_layers`` of them — per-layer EPLB imbalance scales
    individual layers' ``t_moe``.

    Two views of the same schedule:

    * :meth:`schedule` — the discrete event-by-event timeline (the
      analytic reference).
    * :meth:`steady_state` — the closed form.

    Both are models: their times are the inputs' stage times composed by
    the schedule, never a measurement of a deployment."""

    def __init__(self, plan: PartitionPlan, times, n_layers: int):
        self.plan = plan
        self.times = times
        self.n_layers = n_layers

    def _layer_times(self, layer: int) -> StageTimes:
        if isinstance(self.times, StageTimes):
            return self.times
        return self.times[layer]

    def schedule(self) -> PipelineReport:
        """Three concurrent streams on the expert dies (§5.2): A2E recv,
        MoE compute, E2A send — persistent kernels mean only the MoE
        compute serializes across domains/microbatches; A2E/E2A overlap
        as pure communication latency. Domains run on disjoint attention
        dies and couple only through the MoE compute resource."""
        nd, mb = self.plan.n_dp_domains, self.plan.microbatches
        timeline: List[Tuple[str, int, int, float, float]] = []
        moe_free = 0.0                  # the shared expert-compute stream
        moe_busy = 0.0
        attn_busy = 0.0
        core_free = [0.0] * nd                  # attention-die stream
        mb_ready = [[0.0] * mb for _ in range(nd)]   # per-microbatch dep
        for layer in range(self.n_layers):
            t = self._layer_times(layer)
            # attention phase: each domain's core stream runs its
            # microbatches back to back; microbatch m additionally needs
            # ITS OWN previous-layer combine (other microbatches'
            # expert phases overlap freely — intra-DP parallelism)
            arrivals: List[Tuple[float, int, int]] = []
            for d in range(nd):
                for m in range(mb):
                    a0 = max(core_free[d], mb_ready[d][m])
                    a1 = a0 + t.t_attn
                    core_free[d] = a1
                    attn_busy += t.t_attn
                    timeline.append(("attn", d, m, a0, a1))
                    arrivals.append((a1 + t.t_a2e, d, m))
            # expert phase: the A2E-recv persistent kernel polls all
            # domains' buffers, so the MoE compute stream services
            # buckets in ARRIVAL order (not per-domain issue order —
            # in-order service would head-of-line-block early arrivals
            # behind a straggling domain's dispatch)
            for arrive, d, m in sorted(arrivals):
                m0 = max(arrive, moe_free)
                m1 = m0 + t.t_moe
                moe_free = m1
                moe_busy += t.t_moe
                timeline.append(("moe", d, m, m0, m1))
                mb_ready[d][m] = m1 + t.t_e2a
        # the final layer's last microbatch cannot be overlapped (§7.1)
        total = max(max(max(r) for r in mb_ready), moe_free)
        return PipelineReport(
            iteration_time=total,
            expert_busy=moe_busy / total if total else 0.0,
            attention_busy=attn_busy / (total * nd) if total else 0.0,
            timeline=timeline,
        )

    def steady_state(self) -> PipelineReport:
        """Closed-form steady state of the Fig. 19 schedule.

        Per layer, the pipeline advances by whichever resource binds:

        * the domain's attention stream (``mb · t_attn``),
        * the shared expert-compute stream (``nd · mb · t_moe`` — every
          domain's microbatches serialize on it),
        * or a single microbatch's dependency chain
          (``t_attn + t_a2e + t_moe + t_e2a`` — trampoline latency
          exposed when nothing else fills the gap, the small-batch
          regime where disaggregation loses).

        The final layer's un-overlappable drain (§7.1) is added once.
        ``timeline`` is empty — use :meth:`schedule` for event detail."""
        nd, mb = self.plan.n_dp_domains, self.plan.microbatches
        total = moe_busy = attn_busy = 0.0
        last = None
        for layer in range(self.n_layers):
            t = self._layer_times(layer)
            chain = t.t_attn + t.t_a2e + t.t_moe + t.t_e2a
            period = max(mb * t.t_attn, nd * mb * t.t_moe, chain)
            total += period
            moe_busy += nd * mb * t.t_moe
            attn_busy += nd * mb * t.t_attn
            last = (t, period)
        if last is not None:
            # drain: the last microbatch's A2E→MoE→E2A tail beyond what
            # the final period already covers past its attention stage
            t, period = last
            total += max(0.0, (t.t_a2e + t.t_moe + t.t_e2a)
                         - max(0.0, period - t.t_attn))
        return PipelineReport(
            iteration_time=total,
            expert_busy=moe_busy / total if total else 0.0,
            attention_busy=attn_busy / (total * nd) if total else 0.0,
            timeline=[],
        )


def paper_stage_times(cfg: ModelConfig, batch_per_die: int = 96) -> StageTimes:
    """The paper's §7.1 stage times on Ascend 910C dies (seconds), not
    times of this port's device: MLAProlog+MLA+gating+A2E-stage-1 ≈
    0.7 ms per layer per microbatch pair; A2E 0.17 ms, MoE 0.12 ms, E2A
    0.19 ms."""
    return StageTimes(t_attn=0.7e-3, t_a2e=0.17e-3, t_moe=0.12e-3,
                      t_e2a=0.19e-3)
