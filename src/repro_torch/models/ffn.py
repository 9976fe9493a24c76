"""FFN blocks: dense SwiGLU MLP and Mixture-of-Experts.

The MoE layer runs the pull-based gather strategy of the reference on
one device (experts replicated): route in f32, pack capacity buckets
through the fused route-pack kernel, which counts the routed logical ids
per expert (EPLB Collect) in the same launch, run the grouped expert FFN
kernel over the buckets, then combine with the routing weights in f32
and add the shared expert. Decode, chunked prefill and prefill all take it, as
they do in the reference whenever the EP degree is 1.

EPLB placement (§4.5): ``moe_apply`` optionally takes a per-layer
``placement = (replica_slots [E, R], n_replicas [E], phys_owner
[n_phys])``. Each token assignment is then routed to a physical replica
slot (round-robin of the token index across the expert's replicas),
buckets are per physical slot, and the grouped FFN is owner-indexed:
slot ``s`` reads expert ``phys_owner[s]``'s weights in place, with no
gathered copy. With no redundancy this is bit-identical to logical
routing.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.gmm.ops import expert_ffn
from repro_torch.kernels.route_pack.ops import (fused_route_pack,
                                                placement_route)
from repro_torch.models.common import microbatch_sizes

Params = Dict[str, torch.Tensor]


# ===========================================================================
# Dense MLP (SwiGLU)
# ===========================================================================
def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, params["wi_gate"])
    u = torch.matmul(x, params["wi_up"])
    return torch.matmul(torch.nn.functional.silu(g) * u, params["wo"])


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
                      microbatches: int = 1, placement=None):
    """x: [B, S, d] → (y [B, S, d], (lb, z, counts)), experts replicated
    on this device. ``microbatches >= 2`` splits the batch into §4.4
    ping-pong micro-batches, each running the full chain (stats become
    token-weighted averages)."""
    e = cfg.moe

    def run(x):
        B, S, d = x.shape
        T = B * S
        k, E = e.top_k, e.num_experts
        xf = x.reshape(T, d)
        idx, w, probs, logits = _route(xf, params["router"], k)

        N = T * k
        flat_idx = idx.reshape(N)
        flat_w = w.reshape(N)
        tok_of = torch.arange(T, device=x.device).repeat_interleave(k)
        # expected assignments PER EXPERT = N/E; placement buckets use
        # the same logical capacity (a slot's round-robin share never
        # exceeds its owner's load), so budget 0 stays bit-identical
        cap = max(int(N / E * e.capacity_factor), 4)
        owner = None
        if placement is not None:
            rep_slots, n_rep, owner = placement
            dest = placement_route(flat_idx, tok_of, rep_slots, n_rep)
            n_slots, logical = owner.shape[0], flat_idx
        else:
            dest, n_slots = flat_idx.to(torch.int32), E
            logical = dest
        # Collect counts logical experts, whatever slots dest names
        pack = fused_route_pack(xf, dest, k=k, n_dest=n_slots, capacity=cap,
                                count_ids=logical, n_count=E)
        lb, z, counts = _aux_stats(probs, pack.counts, E, logits)
        out_b = expert_ffn(pack.buckets, params["we_gate"], params["we_up"],
                           params["we_down"],
                           phys_owner=owner).to(pack.buckets.dtype)
        y_assign = out_b[dest.long(), pack.rank.long().clamp(0, cap - 1)]
        y_assign = torch.where(pack.keep[:, None], y_assign.float(),
                               torch.zeros((), device=x.device))
        y = combine_assignments(y_assign * flat_w[:, None], k)
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
    return y.to(x.dtype), (lb, z, counts)


def moe_apply(params: Params, x: torch.Tensor, *, cfg: ModelConfig,
              mode: str, placement=None, microbatches: int = 1
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] → (y [B, S, d], aux). ``mode`` is ``prefill``,
    ``chunk`` or ``decode``; ``microbatches`` applies to decode only,
    and so does ``placement``: the caller passes it only there."""
    if mode not in ("prefill", "chunk", "decode"):
        raise ValueError(f"moe_apply: unsupported mode {mode!r}")
    e = cfg.moe
    y, (lb, z, counts) = _moe_gather_local(
        x, params, cfg,
        microbatches=microbatches if mode == "decode" else 1,
        placement=placement)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x)
    aux = {"moe_lb_loss": lb * e.router_aux_coef,
           "moe_z_loss": z * e.router_z_coef,
           "expert_counts": counts}
    return y, aux
