"""KV transfer for disaggregated Prefill-Decode (§5.1).

On CloudMatrix the bytes move through XCCL send/recv over UB (or RoCE for
910B prefill). Here a cache is a tree of tensors in the model's layout
(``Model.init_cache``): ``"prefix"`` is a tuple of per-layer dicts of
``[B, L, ...]`` leaves and ``"blocks"`` a dict of stacked ``[n_sb, B, L,
...]`` leaves, so the sequence axis is 1 for the first and 2 for the
second. The protocol concerns (deferred triggering, ordering,
backpressure, isolated failure domains) live in ``serving/distflow.py``,
which drives this module; ``plan_transfer`` gives it the bytes of a
transfer and their *modeled* time on the paper's fabric
(``xccl/topology.py``), and ``execute_transfer`` moves the tensors.

On a mesh (one process per rank) a :class:`KVLayout` is the port's
stand-in for the reference's tree of ``NamedSharding``s on a decode
mesh: ``execute_transfer(kv, layout)`` gives each decode rank its block
of the KV under the layout's specs. Within one group of ranks each rank
cuts its block (no wire); across a group axis of the mesh (``pd``: rank
group 0 prefills, group 1 decodes) each prefill rank cuts the block of
the decode rank at its own coordinates and sends it over that axis
(``MeshCtx.ppermute``, counted in ``Comm.sent`` and ``.staged``). The
KV trees handed in are global (a chunk buffer holds every slot and KV
head on every rank; a decode rank passes stand-ins of the global
shapes, e.g. ``meta`` tensors), so :func:`pytree_bytes` and
:func:`plan_transfer` count the global tree's bytes, as the reference's.

Chunk streaming (chunked prefill)
---------------------------------

With chunk-granular prefill each finished chunk's KV ships to the decode
side while the next chunk computes: :func:`slice_kv_chunk` cuts one
chunk's token range out of a (partial) prefill cache,
:func:`assemble_chunks` re-concatenates the received chunks on the decode
side, and :func:`chunk_stream_time` is the latency model of the
compute/transfer pipeline (the exposed cost of a streamed prefill is
essentially the last chunk's transfer).

Every slice and every read returns fresh storage: a view of the prefill
buffer would change when the next chunk (and its padded tail) writes that
buffer in place, and would keep the whole buffer alive.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch import sharding as shd
from repro_torch.xccl.topology import best_transfer_time

PyTree = Any


@dataclasses.dataclass
class TransferPlan:
    n_leaves: int
    total_bytes: int
    modeled_time_s: float
    fabric: str


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map_seq(fn, *trees, stacked: bool = False):
    """``fn(*leaves, seq_axis)`` over trees of the cache layout: the
    sequence axis is 2 under ``"blocks"`` (stacked superblock leaves) and
    1 elsewhere."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map_seq(fn, *(t[k] for t in trees),
                            stacked=stacked or k == "blocks") for k in t0}
    if isinstance(t0, (tuple, list)):
        return tuple(_map_seq(fn, *(t[i] for t in trees), stacked=stacked)
                     for i in range(len(t0)))
    return fn(*trees, 2 if stacked else 1)


def pytree_bytes(tree: PyTree) -> int:
    return sum(int(x.numel()) * x.element_size() for x in _leaves(tree))


def plan_transfer(kv: PyTree, fabric: str = "ub") -> TransferPlan:
    """Metadata-only registration (paper §5.1 step 3: the PD-transfer task
    holds only metadata; data moves when the decode side triggers it).
    ``modeled_time_s`` is the paper fabric's time, not the card's."""
    total = pytree_bytes(kv)
    return TransferPlan(
        n_leaves=len(_leaves(kv)),
        total_bytes=total,
        modeled_time_s=best_transfer_time(total, fabric),
        fabric=fabric,
    )


#: the rank groups along a ``KVLayout``'s axis (``launch.mesh.PD_AXES``)
PREFILL_GROUP, DECODE_GROUP = 0, 1


@dataclasses.dataclass(frozen=True)
class KVLayout:
    """Where a KV tree lands on a mesh (module docstring).

    ``ctx``: the decode side's :class:`~repro_torch.models.mesh_ctx.
    MeshCtx`, whose mesh may carry the group axis its collectives never
    name; ``specs``: a :class:`~repro_torch.launch.sharding.PSpec` tree
    matching the KV tree (``cache_pspecs`` of its global shapes under
    ``ctx`` gives the decode layout), or None: every leaf whole on each
    decode rank; ``axis``: the group axis the KV crosses, from group
    :data:`PREFILL_GROUP` to :data:`DECODE_GROUP` (None: the source's
    ranks are the destination's); ``device``: where a decode rank keeps
    its blocks."""
    ctx: Any
    specs: Optional[PyTree] = None
    axis: Optional[str] = None
    device: Any = "cuda"

    def _flat_specs(self, kv: PyTree) -> List[Any]:
        if self.specs is None:
            return [shd.PSpec()] * len(_leaves(kv))
        out: List[Any] = []
        shd.map_with_paths(self.specs, lambda _k, sp: out.append(sp))
        return out

    def cuts_sequence(self) -> bool:
        """True when some leaf's sequence dim is cut: blocks of chunks
        then do not concatenate into the block of the whole prompt."""
        if self.specs is None:
            return False
        cut: List[bool] = []
        shd.map_with_paths(self.specs, lambda keys, sp: cut.append(
            sp.entry(2 if "blocks" in keys else 1) is not None))
        return any(cut)

    def place(self, kv: PyTree) -> Optional[PyTree]:
        """This rank's blocks of ``kv`` under the layout: a decode rank's
        tree of blocks; None on a rank of the source group across
        ``axis`` (it keeps no block of the destination)."""
        ctx, leaves = self.ctx, _leaves(kv)
        specs = self._flat_specs(kv)
        if self.axis is None:
            blocks = iter([shd.take_local(t, sp, ctx)
                           for t, sp in zip(leaves, specs)])
            return _map_seq(lambda _t, _ax: next(blocks), kv)
        me = ctx.comm.coords[self.axis]
        shapes = [shd.local_shape(t.shape, sp, ctx)
                  for t, sp in zip(leaves, specs)]
        sizes = [int(torch.Size(s).numel()) * t.element_size()
                 for s, t in zip(shapes, leaves)]
        if me == PREFILL_GROUP:
            # the block of the decode rank at this rank's coordinates,
            # every leaf's bytes in one buffer: one send over the axis
            wire = torch.cat([shd.take_local(t, sp, ctx).contiguous()
                              .view(-1).view(torch.uint8)
                              for t, sp in zip(leaves, specs)])
        else:
            wire = torch.empty(sum(sizes), dtype=torch.uint8,
                               device=self.device)
        got = ctx.ppermute(wire, self.axis, [(PREFILL_GROUP, DECODE_GROUP)])
        if me == PREFILL_GROUP:
            return None
        parts = iter(torch.split(got, sizes))
        blocks = iter([next(parts).clone().view(t.dtype).view(s)
                       for t, s in zip(leaves, shapes)])
        return _map_seq(lambda _t, _ax: next(blocks), kv)


def execute_transfer(kv: PyTree, dst: Optional[Any] = None) -> PyTree:
    """Move the KV tree to the decode side: ``dst`` None hands it off in
    place (one card, tests), a device moves it there (``.to``), a
    :class:`KVLayout` reshards it onto the decode ranks (``place``)."""
    if dst is None:
        return kv
    if isinstance(dst, KVLayout):
        return dst.place(kv)
    return _map_seq(lambda t, _ax: t.to(dst), kv)


# ---------------------------------------------------------------------------
# Chunk streaming
# ---------------------------------------------------------------------------
def slice_kv_chunk(kv: PyTree, start: int, end: int) -> PyTree:
    """Copy token positions ``[start, end)`` out of a prefill cache: the
    per-chunk payload a streamed PD transfer ships, and one radix-cache
    block's payload. Fresh storage (module docstring)."""
    return _map_seq(lambda t, ax: t.narrow(ax, start, end - start).clone(),
                    kv)


def assemble_chunks(chunks: Sequence[PyTree]) -> PyTree:
    """Decode-side reassembly: concatenate received chunk payloads back
    into one contiguous cache along the sequence axis (inverse of
    :func:`slice_kv_chunk` over consecutive ranges)."""
    if not chunks:
        raise ValueError("no chunks to assemble")
    if len(chunks) == 1:
        return chunks[0]
    return _map_seq(lambda *ls: torch.cat(ls[:-1], dim=ls[-1]), *chunks)


def ub_read(kv: PyTree) -> PyTree:
    """One-sided UB global-shared-memory read of a remote DP's stored KV.

    CloudMatrix-Infer's pod-pooled prefix cache lets any NPU read any
    cached block over the UB plane without involving the owner's compute
    stream; the owner keeps the blocks pinned (``PodKVDirectory.acquire``)
    for the read. On one card the read is a device-to-device copy into
    fresh tensors, bit-identical to the owner's payloads, so a
    remote-hit-seeded prefill stays exactly equal to a local-hit one.
    Leaves that are not tensors pass through unchanged."""
    return _map_seq(
        lambda t, _ax: t.clone() if isinstance(t, torch.Tensor) else t, kv)


def ub_read_time(total_bytes: int, fabric: str = "ub") -> float:
    """Modeled wire time of a pooled-KV read on the paper's fabric (the
    link model the chunk-streamed PD transfer prices with)."""
    return best_transfer_time(int(total_bytes), fabric)


def chunk_stream_time(chunk_bytes: Sequence[int],
                      chunk_compute_s: Sequence[float],
                      fabric: str = "ub") -> Tuple[float, float]:
    """Latency model of layer/chunk-overlapped KV streaming.

    Chunk ``i``'s transfer starts when its compute finishes and the link
    is free; chunk ``i+1``'s compute runs concurrently. Returns
    ``(total_time, exposed_transfer)`` where ``exposed_transfer`` is the
    transfer time NOT hidden under compute — for well-sized chunks this
    is just the final chunk's wire time, vs the whole cache's for a
    post-hoc bulk copy."""
    if len(chunk_bytes) != len(chunk_compute_s):
        raise ValueError("chunk_bytes and chunk_compute_s must align")
    t = 0.0
    link_free = 0.0
    for nbytes, compute in zip(chunk_bytes, chunk_compute_s):
        t += compute                      # compute end of this chunk
        start = max(t, link_free)
        link_free = start + best_transfer_time(int(nbytes), fabric)
    total = max(link_free, t)
    return total, total - t
