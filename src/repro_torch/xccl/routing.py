"""XCCL expert-parallel collectives: dispatch / combine / A2E / E2A,
and the token-wise INT8 wire format (§3.2 step 2, §4.7 "communication
quantization": quantize before the wire, dequantize after).

* ``dispatch_local`` / ``combine_local`` (§3.2): capacity-bucketed
  all-to-all over the EP axis, with the payload optionally INT8 on the
  wire. Stage 1 packs each assignment for its destination EP rank with
  the fused route-pack kernel (``n_dest = ep_size``, its INT8 branch when
  ``quantize``); stage 2 packs the received rows for the local experts,
  the ``valid``-masked pack. They run on each rank over the mesh
  context's collectives (``models/mesh_ctx.py``), one process per rank.
* ``a2e_local`` / ``e2a_local`` (§3.3): attention ranks [0, n_attn) send
  to their trampoline (an identity ``ppermute``: point to point, O(1)
  metadata), trampolines fan out to every expert rank by all-to-all;
  E2A reverses the two stages.

The disaggregated MoE-Attention driver packs its A2E payload through
route-pack's INT8 branch, which applies :func:`quantize_tokens`'s formula
inside the kernel, and the expert side reads it back through
:func:`dequantize_tokens`. Both are plain tensor code on any device: the
combine's requantize of the expert outputs runs :func:`quantize_tokens`,
not the quant-dispatch kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.route_pack.ops import fused_route_pack


def quantize_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-wise INT8: x [..., d] → (int8 values, f32 scale per token),
    ``scale = max(amax, 1e-8) · (1/127)``, then round-half-to-even of a
    true divide by the scale, clipped to ±127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0]


def dequantize_tokens(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(int8 values [..., d], f32 scales [...]) → f32 [..., d]."""
    return q.float() * scale[..., None]


# ---------------------------------------------------------------------------
# Dispatch / combine over the EP axis (§3.2)
# ---------------------------------------------------------------------------
def dispatch_local(x_assign, flat_idx, *, ctx, ep_axis, ep_size: int,
                   n_experts: int, capacity_factor: float = 1.25,
                   quantize: bool = True):
    """One rank's dispatch. x_assign [N, d] payload per assignment,
    flat_idx [N] global expert ids → (expert buckets [E_local, C_e, d]
    f32, routing state for :func:`combine_local`: (flat_eid, rank2,
    keep2, dest_rank, rank1, keep1, cap_s, cap_e))."""
    n, d = x_assign.shape
    e_local = n_experts // ep_size
    cap_s = max(int(n / ep_size * capacity_factor), 4)
    dest_rank = torch.div(flat_idx, e_local, rounding_mode="floor").to(
        torch.int32)
    pack = fused_route_pack(x_assign, dest_rank,
                            eid=torch.remainder(flat_idx, e_local),
                            n_dest=ep_size, capacity=cap_s,
                            quantize=quantize)
    # ---- the wire (all-to-all over the EP ranks) ----------------------
    recv_tok = ctx.all_to_all(pack.buckets, ep_axis)
    recv_eid = ctx.all_to_all(pack.eids, ep_axis)
    if quantize:
        recv_sc = ctx.all_to_all(pack.scales, ep_axis)
        flat = dequantize_tokens(recv_tok.reshape(-1, d),
                                 recv_sc.reshape(-1))
    else:
        flat = recv_tok.reshape(-1, d).float()
    flat_eid = recv_eid.reshape(-1)
    valid = flat_eid >= 0
    cap_e = max(int(flat.shape[0] / e_local * capacity_factor), 4)
    pack2 = fused_route_pack(flat, torch.where(valid, flat_eid,
                                               torch.zeros_like(flat_eid)),
                             valid=valid, n_dest=e_local, capacity=cap_e)
    state = (flat_eid, pack2.rank, pack2.keep, dest_rank, pack.rank,
             pack.keep, cap_s, cap_e)
    return pack2.buckets, state


def combine_local(expert_out, state, *, ctx, ep_axis, ep_size: int,
                  quantize: bool = True):
    """Reverse routing: expert buckets [E_local, C_e, d] → per-assignment
    outputs [N, d] f32 (zeros for dropped assignments)."""
    flat_eid, rank2, keep2, dest_rank, rank1, keep1, cap_s, cap_e = state
    d = expert_out.shape[-1]
    zero = torch.zeros((), device=expert_out.device)
    y_flat = expert_out[torch.where(flat_eid >= 0, flat_eid,
                                    torch.zeros_like(flat_eid)).long(),
                        rank2.long().clamp(0, cap_e - 1)]
    y_flat = torch.where(keep2[:, None], y_flat.float(), zero)
    if quantize:
        qv, sc = quantize_tokens(y_flat)
        back_q = ctx.all_to_all(qv.reshape(ep_size, cap_s, d), ep_axis)
        back_s = ctx.all_to_all(sc.reshape(ep_size, cap_s), ep_axis)
        back = dequantize_tokens(back_q.reshape(-1, d),
                                 back_s.reshape(-1)).reshape(ep_size, cap_s,
                                                             d)
    else:
        back = ctx.all_to_all(y_flat.reshape(ep_size, cap_s, d), ep_axis)
    y_assign = back[dest_rank.long(), rank1.long().clamp(0, cap_s - 1)]
    return torch.where(keep1[:, None], y_assign, zero)


# ---------------------------------------------------------------------------
# A2E / E2A with trampoline forward (§3.3)
# ---------------------------------------------------------------------------
def a2e_local(payload, *, ctx, role_axis, n_attn: int, n_expert: int):
    """payload [n_expert, C, d]: this rank's buckets for each expert rank
    (zeros on pure expert ranks). Stage 1: attention rank ``a`` hands its
    buffer to trampoline ``a`` (identity ppermute; other ranks get
    zeros). Stage 2: trampolines all-to-all the buckets to the expert
    ranks."""
    staged = ctx.ppermute(payload, role_axis,
                          [(a, a) for a in range(n_attn)])
    return ctx.all_to_all(staged, role_axis)


def e2a_local(payload, *, ctx, role_axis, n_attn: int, n_expert: int):
    """Expert → attention: all-to-all to the trampolines (E2A'), then the
    trampolines forward to their attention ranks (E2A)."""
    staged = ctx.all_to_all(payload, role_axis)
    return ctx.ppermute(staged, role_axis, [(a, a) for a in range(n_attn)])


def make_a2e_e2a(ctx, role_axis, n_attn: int, n_expert: int):
    """(a2e, e2a) over this rank's payload block [n_expert, C, d], the
    ranks of ``role_axis`` (``n_expert`` of them) taking both roles."""
    def a2e(x):
        return a2e_local(x, ctx=ctx, role_axis=role_axis, n_attn=n_attn,
                         n_expert=n_expert)

    def e2a(x):
        return e2a_local(x, ctx=ctx, role_axis=role_axis, n_attn=n_attn,
                         n_expert=n_expert)
    return a2e, e2a
