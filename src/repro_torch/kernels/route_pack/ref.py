"""Plain PyTorch version of the fused route-pack kernel.

The capacity-bucket chain written out in tensor ops: FIFO rank of each
assignment within its destination by a cumulative sum over a one-hot,
``keep = rank < capacity ∧ valid``, optional per-token INT8, and a
scatter of the kept rows. Rows whose destination equals ``n_dest`` are
padding: they take no rank (rank 0) and are never kept, exactly like
the padded rows of the TPU kernel. Masked rows (``valid == 0``) still
take a rank slot of their destination. Given ``count_ids``, the pack also
carries their EPLB Collect histogram, computed by Collect's plain version.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.collect.ref import collect_ref


class RoutePack(NamedTuple):
    buckets: torch.Tensor             # [n_dest, C, d] int8 (quant) | payload
    scales: Optional[torch.Tensor]    # [n_dest, C] f32, quantize only
    eids: Optional[torch.Tensor]      # [n_dest, C] int32 (fill -1)
    rank: torch.Tensor                # [N] int32 FIFO rank within dest
    keep: torch.Tensor                # [N] bool  (rank < capacity & valid)
    counts: Optional[torch.Tensor] = None  # [n_count] int32, if asked for


def _capacity_rank(dest, n_dest):
    # one extra column collects padding rows (dest == n_dest)
    onehot = torch.nn.functional.one_hot(dest.long(), n_dest + 1)[:, :n_dest]
    ranks = torch.cumsum(onehot, dim=0) - 1
    safe = dest.long().clamp(max=n_dest - 1)
    my_rank = torch.gather(ranks, 1, safe[:, None])[:, 0]
    return torch.where(dest < n_dest, my_rank, torch.zeros_like(my_rank))


def quantize_rows(x):
    """Per-row INT8: ``scale = max(amax, 1e-8) · (1/127)``, then
    round-half-to-even of a true divide, clipped to ±127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) * torch.tensor(1.0 / 127.0,
                                                       dtype=torch.float32)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0]


def _scatter(values, dest, rank, keep, n_dest, capacity, fill=0):
    """The kept rows of ``values`` into ``[n_dest, capacity, ...]`` at
    (dest, rank), ``fill`` elsewhere. Shape-static (no index list of the
    kept rows): a row not kept writes a spare slot past the end, which
    is dropped, so the result and its gradient are those of scattering
    the kept rows alone (kept slots are distinct)."""
    tail = tuple(values.shape[1:])
    buf = torch.full((n_dest * capacity + 1,) + tail, fill,
                     dtype=values.dtype, device=values.device)
    slot = torch.where(keep, dest.long() * capacity + rank.long(),
                       torch.full_like(rank, n_dest * capacity,
                                       dtype=torch.long))
    buf = buf.index_put((slot,), values)
    return buf[:-1].view((n_dest, capacity) + tail)


def route_pack_ref(x, dest, valid=None, eid=None, *, k: int = 1,
                   n_dest: int, capacity: int, quantize: bool = False,
                   count_ids=None, n_count: int = 0) -> RoutePack:
    """x [T, d]; dest [N=T*k] int32 in [0, n_dest] (n_dest = padding);
    valid [N] bool (None ⇒ all valid); eid [N] int32 payload or None;
    count_ids [N] int32/int64 ids to count over ``[0, n_count)`` (ids
    outside count nowhere), or None."""
    N = dest.shape[0]
    dest = dest.to(torch.int32)
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=dest.device)
    tok_of = torch.arange(N, device=dest.device) // k
    rank = _capacity_rank(dest, n_dest)
    keep = (rank < capacity) & valid.bool() & (dest < n_dest)
    payload = x[tok_of]
    scales = None
    if quantize:
        qv, sc = quantize_rows(payload)
        buckets = _scatter(qv, dest, rank, keep, n_dest, capacity)
        scales = _scatter(sc, dest, rank, keep, n_dest, capacity)
    else:
        buckets = _scatter(payload, dest, rank, keep, n_dest, capacity)
    eids = None
    if eid is not None:
        eids = _scatter(eid.to(torch.int32), dest, rank, keep, n_dest,
                        capacity, fill=-1)
    counts = None if count_ids is None else collect_ref(count_ids, n_count)
    return RoutePack(buckets, scales, eids, rank.to(torch.int32), keep,
                     counts)
