"""FFN blocks: dense SwiGLU MLP and Mixture-of-Experts.

On one device the MoE layer runs the reference's pull-based gather
strategy with the experts replicated: route in f32, pack capacity buckets
through the fused route-pack kernel, which counts the routed logical ids
per expert (EPLB Collect) in the same launch, run the grouped expert FFN
kernel over the buckets, then combine with the routing weights in f32
and add the shared expert. Decode, chunked prefill, prefill and training
all take it, as they do in the reference whenever the EP degree is 1.
The training mode runs the plain route-pack and grouped FFN on every
device (``use_kernel=False``, the reference's ``use_pallas=False``): the
kernels have no backward. The aux losses keep the reference's
gradients: the load-balance loss through the mean router probability
only (the counts carry none), the z-loss through the router logits.

EPLB placement (§4.5): ``moe_apply`` optionally takes a per-layer
``placement = (replica_slots [E, R], n_replicas [E], phys_owner
[n_phys])``. Each token assignment is then routed to a physical replica
slot (round-robin of the token index across the expert's replicas),
buckets are per physical slot, and the grouped FFN is owner-indexed:
slot ``s`` reads expert ``phys_owner[s]``'s weights in place, with no
gathered copy. With no redundancy this is bit-identical to logical
routing.

One code path serves one device and a mesh (``ctx``, one process per
rank; on one device every collective is the identity). ``moe_apply``
picks the reference's strategy: ``alltoall`` dispatch/combine (§3.2) off
decode when the experts and the sequence divide the EP axis, else the
pull-based gather, with the experts sharded over the EP axes when they
divide them (``mine`` mask, local ids, ``psum`` combine; tokens
all-gathered over EP axes that overlap the batch axes and sliced back
after: A2E / E2A) and replicated otherwise, as on one device.
Sharded-EP placement block-shards the physical slots over the EP ranks
and reads the experts replicated. The aux statistics are reduced over
the mesh as the reference reduces them. Training on a mesh takes the
same strategies under autograd (the collectives carry their backward,
``models/mesh_ctx.py``), with the plain route-pack and grouped FFN and
the reference's per-shard capacities.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.gmm.ops import expert_ffn
from repro_torch.kernels.route_pack.ops import (fused_route_pack,
                                                placement_route,
                                                placement_route_local)
from repro_torch.models.common import microbatch_sizes
from repro_torch.models.mesh_ctx import Axes, make_smoke_ctx

Params = Dict[str, torch.Tensor]
#: the context of one device: every collective the identity
ONE_DEVICE = make_smoke_ctx()


# ===========================================================================
# Dense MLP (SwiGLU)
# ===========================================================================
def mlp_apply(params: Params, x: torch.Tensor, *, ctx=None,
              tp_axis=None) -> torch.Tensor:
    """SwiGLU. ``tp_axis``: the hidden dim of ``wi_*`` / ``wo`` is this
    rank's block over that axis (tensor parallel): the partial products
    are summed over it in float32."""
    g = torch.matmul(x, params["wi_gate"])
    u = torch.matmul(x, params["wi_up"])
    y = torch.matmul(torch.nn.functional.silu(g) * u, params["wo"])
    if tp_axis is None:
        return y
    return ctx.psum(y.float(), tp_axis).to(y.dtype)


# ===========================================================================
# MoE
# ===========================================================================
def top_k_lowest_first(probs: torch.Tensor, k: int):
    """Top-k along the last axis with ties broken toward the LOWER index
    (the order ``jax.lax.top_k`` gives): a stable descending sort keeps
    equal values in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Returns (expert idx [T,k], weights [T,k] f32, probs [T,E] f32,
    logits [T,E] f32)."""
    logits = torch.matmul(x_flat.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k_lowest_first(probs, top_k)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return idx, w, probs, logits


def _aux_stats(probs, counts, n_experts: int, logits):
    """Load-balance + router-z losses (Switch-style) from ``counts``
    [n_experts] int32, the per-expert assignment counts that route-pack's
    EPLB Collect block made (§4.5 step 1); returns them as float32."""
    counts = counts.float()
    f = counts / torch.clamp(counts.sum(), min=1.0)
    p = probs.mean(dim=0)
    lb = n_experts * torch.sum(f * p)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return lb, z, counts


def combine_assignments(wa: torch.Tensor, k: int) -> torch.Tensor:
    """wa [T*k, d] f32, token t's assignments at rows t*k .. t*k+k-1 →
    y [T, d]: each token's k rows added into zeros in index order
    (j = 0..k-1), the order ``index_add_`` takes on the CPU. The order is
    fixed on every device, so a decode step is bit-reproducible on the
    card, where ``index_add_`` adds with atomics in any order."""
    wa = wa.view(wa.shape[0] // k, k, -1)
    y = wa[:, 0] + 0.0                 # 0 + a_0: -0.0 becomes +0.0
    for j in range(1, k):
        y = y + wa[:, j]
    return y


def _moe_gather_local(x: torch.Tensor, params: Params, cfg: ModelConfig,
                      ctx, ep_axes: Axes = None, ep_size: int = 1,
                      microbatches: int = 1, placement=None,
                      use_kernel: bool = True):
    """Pull-based gather-compute-reduce. x: [B, S, d], this rank's batch
    block → (y [B, S, d], (lb, z, counts)). ``ep_size`` is the effective
    EP degree: 1 when the experts are replicated (one device, or experts
    that do not divide the EP axes: every rank computes every token's
    experts); else each rank takes the assignments of its experts (or,
    under placement, of its physical slots) and a ``psum`` over the EP
    axes combines. EP axes that are also batch axes first all-gather the
    tokens (A2E) and slice this rank's batch block back after the
    combine (E2A). ``microbatches >= 2`` splits the batch into §4.4
    ping-pong micro-batches, each running the full chain (stats become
    token-weighted averages). ``use_kernel=False``: the plain route-pack
    and grouped FFN on any device (training)."""
    e = cfg.moe
    ep_axes = (ep_axes,) if isinstance(ep_axes, str) else tuple(
        ep_axes or ())
    replicated = ep_size == 1
    overlap = (() if replicated
               else tuple(a for a in ep_axes if a in ctx.batch_axes))

    def run(x):
        B, S, d = x.shape
        for a in overlap:              # A2E: tokens fan in to the experts
            x = ctx.all_gather(x, a, dim=0)
        T, k, E = x.shape[0] * S, e.top_k, e.num_experts
        E_local = E if replicated else E // ep_size
        xf = x.reshape(T, d)
        idx, w, probs, logits = _route(xf, params["router"], k)
        N = T * k
        flat_idx = idx.reshape(N)
        flat_w = w.reshape(N)
        tok_of = torch.arange(T, device=x.device).repeat_interleave(k)
        # expected assignments PER EXPERT = N/E, with a 4x skew margin
        # when the experts are sharded; placement buckets use the same
        # logical capacity (a slot's round-robin share never exceeds its
        # owner's load), so budget 0 stays bit-identical
        cap = max(int(N / E * e.capacity_factor
                      * (1 if replicated else 4)), 4)
        owner, mine = None, None
        if placement is not None:
            rep_slots, n_rep, owner = placement
            if replicated:
                dest = placement_route(flat_idx, tok_of, rep_slots, n_rep)
                n_slots = owner.shape[0]
            else:
                # physical slots block-sharded over the EP ranks: ``mine``
                # from slot ownership
                r = ctx.axis_index(ep_axes)
                n_slots = owner.shape[0] // ep_size
                dest, mine = placement_route_local(
                    flat_idx, tok_of, rep_slots, n_rep, r, n_slots)
                owner = owner[r * n_slots:(r + 1) * n_slots]
        elif replicated:
            dest, n_slots = flat_idx.to(torch.int32), E
        else:
            r = ctx.axis_index(ep_axes)
            mine = torch.div(flat_idx, E_local, rounding_mode="floor") == r
            dest = torch.remainder(flat_idx, E_local).to(torch.int32)
            n_slots = E_local
        if mine is not None:
            dest = torch.where(mine, dest, torch.zeros_like(dest))
        # Collect counts logical experts, whatever slots dest names
        logical = dest if placement is None and replicated else flat_idx
        pack = fused_route_pack(xf, dest, valid=mine, k=k, n_dest=n_slots,
                                capacity=cap, count_ids=logical, n_count=E,
                                use_kernel=use_kernel)
        lb, z, counts = _aux_stats(probs, pack.counts, E, logits)
        out_b = expert_ffn(pack.buckets, params["we_gate"], params["we_up"],
                           params["we_down"], phys_owner=owner,
                           use_kernel=use_kernel).to(pack.buckets.dtype)
        y_assign = out_b[dest.long(), pack.rank.long().clamp(0, cap - 1)]
        y_assign = torch.where(pack.keep[:, None], y_assign.float(),
                               torch.zeros((), device=x.device))
        y = combine_assignments(y_assign * flat_w[:, None], k)
        if not replicated:
            y = ctx.psum(y, ep_axes)          # combine (E2A analogue)
        if overlap:                           # E2A: this rank's batch block
            ro = 0
            for a in overlap:
                ro = ro * ctx.axis_size(a) + ctx.axis_index(a)
            y = y.reshape(-1, S, d)[ro * B:(ro + 1) * B].reshape(B * S, d)
        return y.reshape(B, S, d), (lb, z, counts)

    B = x.shape[0]
    sizes = microbatch_sizes(B, microbatches)
    if len(sizes) == 1:
        y, (lb, z, counts) = run(x)
    else:
        outs = [run(c) for c in torch.split(x, list(sizes), dim=0)]
        y = torch.cat([o[0] for o in outs], dim=0)
        wts = [float(sz) / B for sz in sizes]
        lb = sum(o[1][0] * wt for o, wt in zip(outs, wts))
        z = sum(o[1][1] * wt for o, wt in zip(outs, wts))
        counts = sum(o[1][2] for o in outs)
    # stats: reduce over the batch axes the EP gather did not cover
    stat_axes = tuple(a for a in ctx.batch_axes if a not in overlap)
    lb, z = ctx.pmean(lb, stat_axes), ctx.pmean(z, stat_axes)
    counts = ctx.psum(counts, stat_axes)
    return y.to(x.dtype), (lb, z, counts)


# ---------------------------------------------------------------------------
# On a mesh: all-to-all dispatch/combine (XCCL §3.2)
# ---------------------------------------------------------------------------
def _moe_alltoall_local(x, params, cfg: ModelConfig, ctx, ep_axis: str,
                        ep_size: int, all_axes: Tuple[str, ...],
                        use_kernel: bool = True):
    """One rank's body. x: [B_l, S_l, d], this rank's sequence block over
    ``ep_axis``; the expert weights are this rank's ``E / ep_size``.
    ``use_kernel=False``: the plain route-pack and grouped FFN
    (training)."""
    e = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, e.top_k, e.num_experts
    E_local = E // ep_size
    xf = x.reshape(T, d)
    idx, w, probs, logits = _route(xf, params["router"], k)
    N = T * k
    flat_idx = idx.reshape(N)
    flat_w = w.reshape(N)
    # ---- stage 1: pack per destination rank (counts: EPLB Collect) ------
    dest_rank = torch.div(flat_idx, E_local,
                          rounding_mode="floor").to(torch.int32)
    cap_s = max(int(N / ep_size * e.capacity_factor), 4)
    pack1 = fused_route_pack(xf, dest_rank,
                             eid=torch.remainder(flat_idx, E_local).to(
                                 torch.int32),
                             k=k, n_dest=ep_size, capacity=cap_s,
                             count_ids=flat_idx, n_count=E,
                             use_kernel=use_kernel)
    lb, z, counts = _aux_stats(probs, pack1.counts, E, logits)
    # ---- dispatch ----------------------------------------------------------
    recv_tok = ctx.all_to_all(pack1.buckets, ep_axis)
    recv_eid = ctx.all_to_all(pack1.eids, ep_axis)
    # ---- local experts -----------------------------------------------------
    flat_tok = recv_tok.reshape(ep_size * cap_s, d)
    flat_eid = recv_eid.reshape(ep_size * cap_s)
    valid = flat_eid >= 0
    eid0 = torch.where(valid, flat_eid, torch.zeros_like(flat_eid))
    cap_e = max(int(ep_size * cap_s / E_local * e.capacity_factor), 4)
    pack2 = fused_route_pack(flat_tok, eid0, valid=valid, n_dest=E_local,
                             capacity=cap_e, use_kernel=use_kernel)
    out_b = expert_ffn(pack2.buckets, params["we_gate"], params["we_up"],
                       params["we_down"],
                       use_kernel=use_kernel).to(pack2.buckets.dtype)
    y_flat = out_b[eid0.long(), pack2.rank.long().clamp(0, cap_e - 1)]
    y_flat = torch.where(pack2.keep[:, None], y_flat,
                         torch.zeros((), dtype=y_flat.dtype,
                                     device=x.device)).to(x.dtype)
    # ---- combine: reverse all-to-all + weighted sum, in x's dtype ---------
    back = ctx.all_to_all(y_flat.reshape(ep_size, cap_s, d), ep_axis)
    y_assign = back[dest_rank.long(), pack1.rank.long().clamp(0, cap_s - 1)]
    y_assign = torch.where(pack1.keep[:, None], y_assign,
                           torch.zeros((), dtype=y_assign.dtype,
                                       device=x.device))
    y = combine_assignments((y_assign * flat_w[:, None]).to(x.dtype), k)
    # every rank holds distinct tokens: reduce over batch AND EP axes
    return y.reshape(B, S, d), (ctx.pmean(lb, all_axes),
                                ctx.pmean(z, all_axes),
                                ctx.psum(counts, all_axes))


def _experts(params: Params, ctx, ep_axes, E: int, local: bool) -> Params:
    """The expert weights as the strategy reads them: this rank's block
    over ``ep_axes`` (``local``) or all ``E``, from whichever the caller
    holds."""
    out = dict(params)
    for n in ("we_gate", "we_up", "we_down"):
        t = params[n]
        if local and t.shape[0] == E:
            out[n] = ctx.take_block(t, 0, ep_axes)
        elif not local and t.shape[0] != E:
            out[n] = ctx.all_gather(t, ep_axes, dim=0)
    return out


def moe_apply(params: Params, x: torch.Tensor, *, cfg: ModelConfig,
              mode: str, placement=None, microbatches: int = 1, ctx=None,
              tp_axis=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] → (y [B, S, d], aux). ``mode`` is ``prefill``,
    ``chunk``, ``decode`` or ``train`` (the plain versions of the
    kernels); ``microbatches`` applies to decode only, and so does
    ``placement``: the caller passes it only there. ``ctx``: the mesh
    context (default: one device); on more than one rank x is this
    rank's batch block and the expert weights this rank's block over
    ``ctx.ep_axis`` or all of them; ``tp_axis``: the shared expert's
    hidden dim is this rank's block over it. The strategy is the
    reference's choice: all-to-all off decode when the experts and the
    sequence divide the EP axis, else the gather, its experts sharded
    when they divide the EP axes."""
    if mode not in ("prefill", "chunk", "decode", "train"):
        raise ValueError(f"moe_apply: unsupported mode {mode!r}")
    e = cfg.moe
    ctx = ONE_DEVICE if ctx is None else ctx
    impl = "gather" if mode == "decode" else ctx.moe_impl
    ep_axis = ctx.ep_axis
    ep_tuple = (ep_axis,) if isinstance(ep_axis, str) else tuple(ep_axis)
    ep_size = ctx.axis_size(ep_axis)
    ep_ok = e.num_experts % ep_size == 0 and ep_size > 1
    seq_ok = x.shape[1] % ep_size == 0 and ep_size > 1
    eff_ep = ep_size if ep_ok else 1
    if impl == "alltoall" and ep_ok and seq_ok and len(ep_tuple) == 1:
        all_axes = tuple(ctx.batch_axes) + tuple(
            a for a in ep_tuple if a not in ctx.batch_axes)
        xs = ctx.take_block(x, 1, ep_tuple[0])
        ys, (lb, z, counts) = _moe_alltoall_local(
            xs, _experts(params, ctx, ep_tuple, e.num_experts, True), cfg,
            ctx, ep_tuple[0], eff_ep, all_axes, use_kernel=mode != "train")
        y = ctx.all_gather(ys, ep_tuple[0], dim=1)
    else:
        local = eff_ep != 1
        if local and placement is not None:
            # sharded-EP placement: pad the owner view to a multiple of
            # eff_ep with dead identity slots (no replica slot names
            # them) and read the experts replicated
            rs_, nr_, owner_ = placement
            pad = (-owner_.shape[0]) % eff_ep
            if pad:
                ext = (torch.arange(owner_.shape[0], owner_.shape[0] + pad,
                                    dtype=owner_.dtype, device=owner_.device)
                       % e.num_experts)
                owner_ = torch.cat([owner_, ext])
            placement = (rs_, nr_, owner_)
            local = False
        y, (lb, z, counts) = _moe_gather_local(
            x, _experts(params, ctx, ep_tuple, e.num_experts, local), cfg,
            ctx, ep_axis, eff_ep,
            microbatches=microbatches if mode == "decode" else 1,
            placement=placement, use_kernel=mode != "train")
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, ctx=ctx, tp_axis=tp_axis)
    aux = {"moe_lb_loss": lb * e.router_aux_coef,
           "moe_z_loss": z * e.router_z_coef,
           "expert_counts": counts}
    return y, aux
