"""Mesh context threaded through model code, and its collectives.

One process runs each rank (SPMD: every rank runs the same Python on the
same requests). A :class:`MeshCtx` says how the model maps onto the
mesh, with the reference's field names and defaults; its ``mesh`` is a
:class:`MeshShape`, an ordered ``{axis: size}``, which may also carry a
live :class:`Comm`: the ``torch.distributed`` groups of this rank, its
coordinates, and the collectives the reference calls through
``jax.lax`` inside ``shard_map`` (``axis_index``, ``psum``, ``pmax``,
``pmean``, tiled ``all_to_all`` on dim 0, ``ppermute``, tiled
``all_gather``). Each takes one axis or a tuple of axes (a flattened
sub-mesh, ranks in row-major order of the tuple, as ``jax.lax`` counts
them). Over an axis of size 1 each is the identity and launches nothing,
so :func:`make_smoke_ctx`'s 1×1 mesh, which has no process group, runs
exactly the one-device path.

The backend is chosen by the caller (``launch/mesh.init_mesh``): NCCL
when each rank has its own card, gloo otherwise. gloo moves host
memory: a CUDA tensor given to a collective over gloo is copied to the
host and back (``Comm._to_wire`` / ``_from_wire``), and the bytes staged
so are counted in ``Comm.staged``. Nothing catches a collective's error.

**Gradients.** Under autograd (grad mode on and an input that requires
grad) each collective is a ``torch.autograd.Function`` whose backward is
its transpose, under one rule: *a rank's cotangent of a value that
several ranks hold is a partial; the value's true cotangent is the sum
of the partials over the ranks that hold it.* So:

  * ``psum`` → ``psum`` of the cotangents (``pmean``: over ``n``);
  * ``all_gather`` → reduce-scatter: the cotangents' blocks exchanged
    by one all-to-all and this rank's block summed over the axis (the
    FSDP rule for every gathered weight);
  * ``all_to_all`` (tiled, dim 0) → itself; ``ppermute`` → the inverse
    permutation;
  * ``pmax`` → no gradient (it only ever shifts a log-sum-exp, as the
    stopped max of ``jax.nn.logsumexp``);
  * ``take_block`` (a ``narrow``) → its native backward: the block's
    cotangent in zeros, a partial;
  * an identity in the forward that feeds consumers split over an axis
    needs no operation at all: each rank's cotangent is the partial of
    its consumers.

A loss every rank holds alike is seeded with ``1 / n`` on each of the
``n`` ranks that compute it (``Model.train_axes``), and a leaf's gradient
is then the sum of its partials over the axes that replicate it: one
float32 all-reduce per group of leaves after the backward
(``Model.reduce_grads``, counted as ``"grad_sum"``); the axes that cut a
leaf were summed by the reduce-scatter of its gather. Backward sums are taken in float32 (the
float16-bits carriage of bf16 only moves bytes) and counted in
``Comm.sent`` / ``Comm.staged`` under their own keys (``"psum.bwd"``,
``"all_gather.bwd"``, ``"all_to_all.bwd"``, ``"ppermute.bwd"``), so a
forward's counts are the same with grad mode on or off. Without grad the
plain collectives run, bit for bit as before.

A :class:`Comm` made with ``shape_only=True`` moves nothing: each
collective returns a tensor of its result's shape (the dry run runs on
``meta`` tensors, as rank 0 of a mesh no process holds) and counts the
bytes it would have sent.
"""
from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Axes = Union[str, Tuple[str, ...], None]


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class MeshShape:
    """A device mesh as a shape: ``shape`` is an ordered ``{axis: size}``
    (what the reference's sharding rules read), ``comm`` the live groups
    of this rank or None (a mesh for resolving rules only)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 comm: Optional["Comm"] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match "
                             f"axes {tuple(axis_names)}")
        self.shape: Dict[str, int] = collections.OrderedDict(
            (str(a), int(s)) for a, s in zip(axis_names, shape))
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.comm = comm

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        live = "" if self.comm is None else f", rank {self.comm.rank}"
        return f"MeshShape({dict(self.shape)}{live})"


class Comm:
    """This rank's place in a live mesh and its collectives.

    ``rank`` is the global rank, laid out row-major over the mesh axes;
    ``backend`` the process group's (``"gloo"`` or ``"nccl"``).
    ``sent`` counts the bytes this rank puts on the wire per collective;
    ``staged`` the bytes a gloo collective copied between the card and
    the host. ``shape_only``: no process group; every collective gives
    a stand-in of its result's shape and counts its bytes (the dry
    run's ``meta`` tensors)."""

    def __init__(self, shape: Dict[str, int], rank: int, backend: str,
                 shape_only: bool = False):
        self.shape_only = shape_only
        self.shape = dict(shape)
        self.names = tuple(shape)
        self.rank = int(rank)
        self.backend = backend
        coords, r = {}, self.rank
        for a in reversed(self.names):
            coords[a] = r % self.shape[a]
            r //= self.shape[a]
        self.coords = {a: coords[a] for a in self.names}
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.sent: "collections.Counter[str]" = collections.Counter()
        self.staged: "collections.Counter[str]" = collections.Counter()

    # ---- groups ---------------------------------------------------------
    def _global_rank(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.names:
            r = r * self.shape[a] + coords[a]
        return r

    def group_ranks(self, axes: Tuple[str, ...]) -> list:
        """Global ranks of this rank's group over ``axes``, in row-major
        order of ``axes`` (group rank = :meth:`index` over ``axes``)."""
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(self.coords)
            c.update(zip(axes, idx))
            out.append(self._global_rank(c))
        return out

    def group(self, axes: Tuple[str, ...]):
        """The process group over ``axes``, made on first use. Every rank
        makes every group of a partition at once, in the same order: the
        SPMD program reaches each collective on every rank."""
        g = self._groups.get(axes)
        if g is None:
            import torch.distributed as dist

            others = [a for a in self.names if a not in axes]
            parts = []
            for idx in itertools.product(*(range(self.shape[a])
                                           for a in others)):
                base = dict(zip(others, idx))
                ranks = []
                for j in itertools.product(*(range(self.shape[a])
                                             for a in axes)):
                    c = dict(base)
                    c.update(zip(axes, j))
                    ranks.append(self._global_rank(c))
                parts.append(ranks)
            g, _ = dist.new_subgroups_by_enumeration(parts,
                                                     backend=self.backend)
            self._groups[axes] = g
        return g

    def index(self, axes: Tuple[str, ...]) -> int:
        r = 0
        for a in axes:
            r = r * self.shape[a] + self.coords[a]
        return r

    # ---- the wire -------------------------------------------------------
    def _to_wire(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """``t`` as the backend takes it: contiguous, and for gloo in host
        memory (the staging copy, counted)."""
        t = t.contiguous()
        if self.backend == "gloo" and t.device.type == "cuda":
            self.staged[name] += t.numel() * t.element_size()
            t = t.cpu()
        return t

    def _from_wire(self, t: torch.Tensor, like: torch.Tensor,
                   name: str) -> torch.Tensor:
        if t.device != like.device:
            self.staged[name] += t.numel() * t.element_size()
            t = t.to(like.device)
        return t


@dataclass(frozen=True)
class MeshCtx:
    """How model code maps onto the mesh (the reference's fields)."""
    mesh: MeshShape
    batch_axes: Tuple[str, ...] = ("data",)   # ("pod","data") multi-pod
    tp_axis: str = "model"                    # tensor-parallel axis
    ep_axis: Axes = "model"                   # expert-parallel axis (or tuple)
    seq_axis: str = "model"                   # KV-cache / sequence shard axis
    # MoE strategy off decode: "alltoall" (dispatch/combine, §3.2) or
    # "gather" (pull-based gather-compute-reduce; decode always)
    moe_impl: str = "alltoall"
    # shard the decode KV cache along the sequence over seq_axis
    # (flash-decoding); False keeps a replicated KV cache
    shard_kv_seq: bool = True
    remat: str = "full"
    # §4.4 decode ping-pong micro-batches (1 = off)
    decode_microbatches: int = 1

    # ------------------------------------------------------------------
    @property
    def bspec(self):
        """Batch spec entry: the tuple of batch axes, or None."""
        return tuple(self.batch_axes) if self.batch_axes else None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.mesh.axis_names

    def axis_size(self, name) -> int:
        if name is None:
            return 1
        if isinstance(name, (tuple, list)):
            out = 1
            for n in name:
                out *= self.axis_size(n)
            return out
        return self.mesh.shape[name]

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.batch_axes)

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp_axis)

    @property
    def named_axes(self) -> Tuple[str, ...]:
        """The mesh axes this context names (batch, TP, EP, sequence), in
        mesh order: a leading axis of replicas or rank groups (``pd``) is
        not one."""
        named = set(self.batch_axes) | {self.tp_axis, self.seq_axis}
        named |= set(_axes(self.ep_axis))
        return tuple(a for a in self.axis_names if a in named)

    @property
    def comm(self) -> Optional[Comm]:
        return self.mesh.comm

    @property
    def sharded(self) -> bool:
        """True on a live mesh or one with more than one rank: the model
        then takes its mesh code path (on a live 1×1 mesh every
        collective is the identity, and the path is the one-device one
        bit for bit)."""
        return self.mesh.size > 1 or self.mesh.comm is not None

    # ------------------------------------------------------------------
    # collectives (jax.lax names); the identity over size-1 axes
    # ------------------------------------------------------------------
    def _live(self, axes: Axes, op: str) -> Tuple[Tuple[str, ...], int]:
        ax = tuple(a for a in _axes(axes) if self.mesh.shape[a] > 1)
        n = self.axis_size(ax)
        if n > 1 and self.comm is None:
            raise RuntimeError(f"{op} over {ax} needs a live mesh "
                               f"(launch.mesh.init_mesh); {self.mesh} has "
                               f"no process group")
        return ax, n

    def axis_index(self, axes: Axes) -> int:
        """Linear index of this rank over ``axes`` (row-major in the
        tuple's order); 0 over size-1 axes."""
        ax, n = self._live(axes, "axis_index")
        return 0 if n == 1 else self.comm.index(ax)

    def _reduce(self, t: torch.Tensor, axes: Axes, op: str,
                key: Optional[str] = None):
        """All-reduce (``op`` "psum" or "pmax") of ``t`` over ``axes``;
        bytes counted under ``key`` (default ``op``)."""
        ax, n = self._live(axes, op)
        if n == 1:
            return t
        c, key = self.comm, key or op
        if c.shape_only:
            c.sent[key] += t.numel() * t.element_size()
            return torch.empty_like(t)
        import torch.distributed as dist

        w = c._to_wire(t, key)
        w = w.clone() if w.data_ptr() == t.data_ptr() else w
        c.sent[key] += w.numel() * w.element_size()
        dist.all_reduce(w, op=(dist.ReduceOp.SUM if op == "psum"
                               else dist.ReduceOp.MAX), group=c.group(ax))
        return c._from_wire(w, t, key)

    def _sum_f32(self, g: torch.Tensor, axes: Axes, key: str):
        """A backward's sum over ``axes``, taken in float32."""
        return self._reduce(g.float(), axes, "psum", key).to(g.dtype)

    def _reduce_scatter(self, g: torch.Tensor, axes: Axes, dim: int,
                        key: str) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of the ranks' ``g``
        over ``axes``: the blocks go out by one tiled all-to-all (bytes
        only: bf16 as float16 bits) and are summed here in float32."""
        n = self._live(axes, "reduce_scatter")[1]
        if n == 1:
            return g
        t = g.movedim(dim, 0)
        got = self._all_to_all(t.contiguous(), axes, key)
        s = got.view((n, t.shape[0] // n) + tuple(t.shape[1:])).float()
        return s.sum(dim=0).to(g.dtype).movedim(0, dim)

    def _grad(self, t: torch.Tensor, axes: Axes) -> bool:
        """Whether a collective over ``axes`` of ``t`` must carry a
        backward: grad mode on, ``t`` requires grad, and ranks to talk
        to."""
        return (torch.is_grad_enabled() and t.requires_grad
                and self._live(axes, "collective")[1] > 1)

    def psum(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        if self._grad(t, axes):
            return _Psum.apply(t, self, axes)
        return self._reduce(t, axes, "psum")

    def pmax(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """The max over ``axes``; it carries no gradient."""
        return self._reduce(t.detach(), axes, "pmax")

    def pmean(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        n = self._live(axes, "pmean")[1]
        return t if n == 1 else self.psum(t, axes) / n

    @staticmethod
    def _bits(t: torch.Tensor) -> torch.Tensor:
        """bf16 carried as float16 bits where only bytes move (gloo has
        no bf16 or int16)."""
        return t.view(torch.float16) if t.dtype == torch.bfloat16 else t

    def all_to_all(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Tiled all-to-all on dim 0: block ``j`` of ``t``'s dim 0 goes to
        rank ``j``; the result holds rank ``j``'s block for this rank at
        block ``j`` (``jax.lax.all_to_all(t, axes, 0, 0, tiled=True)``).
        Its own transpose."""
        if self._grad(t, axes):
            return _AllToAll.apply(t, self, axes)
        return self._all_to_all(t, axes, "all_to_all")

    def _all_to_all(self, t: torch.Tensor, axes: Axes, key: str):
        ax, n = self._live(axes, "all_to_all")
        if n == 1:
            return t
        if t.shape[0] % n:
            raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} is not "
                             f"a multiple of {n}")
        c = self.comm
        if c.shape_only:
            c.sent[key] += t.numel() * t.element_size()
            return torch.empty_like(t)
        import torch.distributed as dist

        w = self._bits(c._to_wire(t, key))
        out = torch.empty_like(w)
        c.sent[key] += w.numel() * w.element_size()
        dist.all_to_all_single(out, w, group=c.group(ax))
        if t.dtype == torch.bfloat16:
            out = out.view(torch.bfloat16)
        return c._from_wire(out, t, key)

    def all_gather(self, t: torch.Tensor, axes: Axes,
                   dim: int = 0) -> torch.Tensor:
        """Tiled all-gather: the ranks' ``t`` concatenated along ``dim``
        in rank order. Its backward is a reduce-scatter
        (:meth:`_reduce_scatter`): this rank's block of the cotangents'
        sum over ``axes``, taken in float32."""
        if self._grad(t, axes):
            return _AllGather.apply(t, self, axes, dim)
        return self._all_gather(t, axes, dim)

    def _all_gather(self, t: torch.Tensor, axes: Axes, dim: int):
        ax, n = self._live(axes, "all_gather")
        if n == 1:
            return t
        c = self.comm
        if c.shape_only:
            c.sent["all_gather"] += t.numel() * t.element_size()
            return torch.cat([t] * n, dim=dim)
        import torch.distributed as dist

        w = self._bits(c._to_wire(t, "all_gather"))
        parts = [torch.empty_like(w) for _ in range(n)]
        c.sent["all_gather"] += w.numel() * w.element_size()
        dist.all_gather(parts, w, group=c.group(ax))
        out = torch.cat(parts, dim=dim)
        if t.dtype == torch.bfloat16:
            out = out.view(torch.bfloat16)
        return c._from_wire(out, t, "all_gather")

    def ppermute(self, t: torch.Tensor, axes: Axes,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Point-to-point permute: for each ``(src, dst)`` of ``perm``
        (indices over ``axes``), rank ``dst`` receives ``src``'s ``t``;
        a rank that receives nothing gets zeros, as in ``jax.lax``.
        Sends and receives go as one ``batch_isend_irecv``. Its backward
        is the inverse permutation."""
        perm = tuple((int(s), int(d)) for s, d in perm)
        if self._grad(t, axes):
            return _Ppermute.apply(t, self, axes, perm)
        return self._ppermute(t, axes, perm, "ppermute")

    def _ppermute(self, t: torch.Tensor, axes: Axes, perm, key: str):
        ax, n = self._live(axes, "ppermute")
        me = self.axis_index(ax) if n > 1 else 0
        send_to = [d for s, d in perm if s == me]
        recv_from = [s for s, d in perm if d == me]
        if n == 1:
            return t.clone() if recv_from else torch.zeros_like(t)
        c = self.comm
        if c.shape_only:
            c.sent[key] += (t.numel() * t.element_size()
                            * sum(d != me for d in send_to))
            return torch.empty_like(t)
        import torch.distributed as dist

        ranks = c.group_ranks(ax)
        w = self._bits(c._to_wire(t, key))
        out = torch.zeros_like(w)
        ops = []
        for d in send_to:
            if d == me:
                out.copy_(w)
                continue
            c.sent[key] += w.numel() * w.element_size()
            ops.append(dist.P2POp(dist.isend, w, ranks[d],
                                  group=c.group(ax)))
        for s in recv_from:
            if s != me:
                ops.append(dist.P2POp(dist.irecv, out, ranks[s],
                                      group=c.group(ax)))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if t.dtype == torch.bfloat16:
            out = out.view(torch.bfloat16)
        return c._from_wire(out, t, key)

    # ------------------------------------------------------------------
    # blocks of a sharded dim
    # ------------------------------------------------------------------
    def take_block(self, t: torch.Tensor, dim: int, axes: Axes):
        """This rank's block of ``t`` along ``dim`` over ``axes``."""
        n = self.axis_size(_axes(axes))
        if n == 1:
            return t
        size = t.shape[dim] // n
        return t.narrow(dim, self.axis_index(axes) * size, size)


# ---------------------------------------------------------------------------
# the collectives' backwards (the rule in the module docstring)
# ---------------------------------------------------------------------------
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, mc: MeshCtx, axes):
        fctx.mc, fctx.axes = mc, axes
        return mc._reduce(t, axes, "psum")

    @staticmethod
    def backward(fctx, g):
        return fctx.mc._sum_f32(g, fctx.axes, "psum.bwd"), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, mc: MeshCtx, axes, dim: int):
        fctx.mc, fctx.axes, fctx.dim = mc, axes, dim
        return mc._all_gather(t, axes, dim)

    @staticmethod
    def backward(fctx, g):
        return (fctx.mc._reduce_scatter(g, fctx.axes, fctx.dim,
                                        "all_gather.bwd"), None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, mc: MeshCtx, axes):
        fctx.mc, fctx.axes = mc, axes
        return mc._all_to_all(t, axes, "all_to_all")

    @staticmethod
    def backward(fctx, g):
        return (fctx.mc._all_to_all(g, fctx.axes, "all_to_all.bwd"), None,
                None)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, mc: MeshCtx, axes, perm):
        fctx.mc, fctx.axes, fctx.perm = mc, axes, perm
        return mc._ppermute(t, axes, perm, "ppermute")

    @staticmethod
    def backward(fctx, g):
        inv = tuple((d, s) for s, d in fctx.perm)
        return (fctx.mc._ppermute(g, fctx.axes, inv, "ppermute.bwd"), None,
                None, None)


def make_smoke_ctx(**kw) -> MeshCtx:
    """1×1 mesh, no process group: the one-device code paths."""
    kw.setdefault("remat", "none")
    return MeshCtx(mesh=MeshShape((1, 1), ("data", "model")),
                   batch_axes=("data",), **kw)
