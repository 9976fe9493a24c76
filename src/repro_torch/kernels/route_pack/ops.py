"""Route-pack entry points: the fused pack and the EPLB slot remap.

:func:`fused_route_pack` launches the hand-written CUDA kernel for a
tensor on the card and takes the plain version (``ref.py``) only for a
tensor on the CPU; any other device raises. There is no fallback: a
failed build or launch on the card raises.

:func:`placement_route` remaps destinations logical → physical replica
slot by exact round-robin of token position (the EPLB data plane,
§4.5); callers apply it to their routed ids before the pack, so a hot
expert's replicas split its load across capacity buckets.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.route_pack.kernel import route_pack_cuda
from repro_torch.kernels.route_pack.ref import RoutePack, route_pack_ref


def placement_route(dest: torch.Tensor, positions: torch.Tensor,
                    replica_slots: torch.Tensor,
                    n_replicas: torch.Tensor) -> torch.Tensor:
    """``slot = replica_slots[dest, positions % n_replicas[dest]]``.

    ``dest`` [N] logical ids; ``positions`` [N] token positions;
    ``replica_slots`` [E, R] cyclically padded; ``n_replicas`` [E] ≥ 1.
    With ``n_replicas == 1`` everywhere this is the identity."""
    dest = dest.long()
    r = positions.long() % n_replicas.long()[dest]
    return replica_slots[dest, r].to(torch.int32)


def placement_route_local(dest, positions, replica_slots, n_replicas,
                          rank: int, n_local: int):
    """Sharded-EP view of :func:`placement_route`: physical slot ``s``
    lives on rank ``s // n_local``. Returns ``(local_slot [N],
    mine [N] bool)``."""
    phys = placement_route(dest, positions, replica_slots, n_replicas)
    mine = torch.div(phys, n_local, rounding_mode="floor") == rank
    return torch.remainder(phys, n_local), mine


def fused_route_pack(x, dest, valid=None, eid=None, *, k: int = 1,
                     n_dest: int, capacity: int, quantize: bool = False,
                     count_ids=None, n_count: int = 0) -> RoutePack:
    """Fused capacity rank + INT8 quantize + bucket scatter, and
    optionally EPLB Collect in the same launch.

    x [T, d] payload rows (assignment ``r`` carries row ``r // k``);
    dest [N = T*k] int32 destinations in [0, n_dest) (``n_dest`` marks
    a padding row); valid [N] optional mask — masked rows still take a
    rank slot; eid [N] optional int32 side payload bucketed with fill
    −1. Under EPLB placement ``dest`` carries physical slot ids and
    ``n_dest`` is the physical slot count. count_ids [N] int32/int64
    (optional): ids whose histogram over ``[0, n_count)`` the pack
    returns as ``counts`` — the MoE layer's logical top-k ids."""
    kw = dict(k=k, n_dest=n_dest, capacity=capacity, quantize=quantize,
              count_ids=count_ids, n_count=n_count)
    if x.device.type == "cuda":
        return route_pack_cuda(x, dest, valid, eid, **kw)
    if x.device.type == "cpu":
        return route_pack_ref(x, dest, valid, eid, **kw)
    raise ValueError(f"route_pack: no kernel for device {x.device}")
