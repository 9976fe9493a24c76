"""Logical-axis sharding rules with divisibility fallback.

The reference's rule tables, copied: parameters are nested dicts and
rules key on (leaf name, ndim), giving each dim a *logical axis*; a
resolver maps logical axes to mesh axes, replicating any dim whose size
does not divide the mesh-axis product or whose mesh axes another dim of
the same parameter already took (so RecurrentGemma's 10 heads fall back
to replication on a 16-way model axis while its d_ff still shards).

A spec is a :class:`PSpec`, a tuple of per-dim entries (None, an axis,
or a tuple of axes) with trailing Nones dropped: it compares one to one
with the reference's ``PartitionSpec``. The rules read only
``mesh.shape``, so they resolve on a shape-only mesh
(``launch/mesh.make_production_mesh``). :func:`shard_tree` cuts this
rank's block of each leaf: the counterpart of the reference's
``param_shardings`` / ``cache_shardings`` placing arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

PyTree = Any

# logical axis → ordered candidate mesh-axis tuples (first fit wins)
LOGICAL_RULES: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "vocab": (("model",), ("data",)),
    "embed": (("data",),),          # FSDP-style shard of d_model
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "mlp": (("model",),),
    "expert": (("model",),),
    "expert_mlp": (("data",),),
    "lru": (("model",),),
    "ssm_inner": (("model",),),
    None: (),
}

# Decode profile: replicate weights over 'data' and shard experts over
# both axes (the paper's EP-per-die layout).
DECODE_RULES: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    **LOGICAL_RULES,
    "embed": (),                       # replicate weights over data
    "expert": (("data", "model"), ("model",)),   # EP across the pod
    "expert_mlp": (),
}

# (leaf name, ndim) → logical axes per dim. None = replicated dim.
PARAM_RULES: Dict[Tuple[str, int], Tuple[Optional[str], ...]] = {
    ("embed", 2): ("vocab", "embed"),
    ("lm_head", 2): ("embed", "vocab"),
    # attention
    ("wq", 3): ("embed", "heads", None),
    ("wk", 3): ("embed", "kv_heads", None),
    ("wv", 3): ("embed", "kv_heads", None),
    ("wo", 3): ("heads", None, "embed"),
    # MLA
    ("wq_a", 2): ("embed", None),
    ("wq_b", 3): (None, "heads", None),
    ("wkv_a", 2): ("embed", None),
    ("wk_b", 3): (None, "heads", None),
    ("wv_b", 3): (None, "heads", None),
    # mlp
    ("wi_gate", 2): ("embed", "mlp"),
    ("wi_up", 2): ("embed", "mlp"),
    ("wo", 2): ("mlp", "embed"),
    # moe
    ("router", 2): (None, None),
    ("we_gate", 3): ("expert", None, "expert_mlp"),
    ("we_up", 3): ("expert", None, "expert_mlp"),
    ("we_down", 3): ("expert", "expert_mlp", None),
    # rglru
    ("w_in", 2): ("embed", "lru"),
    ("w_gate_branch", 2): ("embed", "lru"),
    ("w_out", 2): ("lru", "embed"),
    # ssm
    ("in_proj", 2): ("embed", "ssm_inner"),
    ("out_proj", 2): ("ssm_inner", "embed"),
    # mtp
    ("proj", 2): ("embed", None),
}


class PSpec(tuple):
    """Per-dim mesh-axis entries of one leaf (a tree leaf, not a node).
    A one-axis tuple entry is stored as the axis, an empty one as None,
    as ``PartitionSpec`` stores them."""
    _fields = ()

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PSpec{tuple(self)!r}"

    def entry(self, dim: int):
        return self[dim] if dim < len(self) else None


def _resolve(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
             mesh, rules=None) -> PSpec:
    """Greedy per-dim assignment with divisibility + axis-uniqueness."""
    rules = rules or LOGICAL_RULES
    used = set()
    entries = []
    for size, lname in zip(shape, logical):
        assigned = None
        for cand in rules.get(lname, ()):
            axes = tuple(a for a in cand if a in mesh.shape)
            if not axes or any(a in used for a in axes):
                continue
            prod = 1
            for a in axes:
                prod *= mesh.shape[a]
            if prod > 1 and size % prod == 0:
                assigned = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                break
        entries.append(assigned)
    while entries and entries[-1] is None:
        entries.pop()
    return PSpec(*entries)


def map_with_paths(tree, fn, keys=()):
    """``tree`` rebuilt with ``fn(keys, leaf)`` at each leaf, ``keys``
    the dict keys and tuple indices down to it (a ``PSpec`` or other
    NamedTuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: map_with_paths(v, fn, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return tuple(map_with_paths(v, fn, keys + (i,))
                     for i, v in enumerate(tree))
    return fn(keys, tree)


def leaves_by_path(tree) -> Dict[tuple, Any]:
    """``tree``'s leaves keyed by their paths (as :func:`map_with_paths`
    passes them)."""
    out: Dict[tuple, Any] = {}
    map_with_paths(tree, lambda k, t: out.__setitem__(k, t))
    return out


def param_logical(keys: tuple, ndim: int):
    """(stacked, logical axes of the leaf's core dims or None): a leaf
    under ``blocks`` has a leading layer-stack dim, never sharded."""
    name = keys[-1] if keys and isinstance(keys[-1], str) else "?"
    stacked = "blocks" in keys
    return stacked, PARAM_RULES.get((name, ndim - (1 if stacked else 0)))


def param_pspecs(params_shape: PyTree, mesh, rules=None) -> PyTree:
    """A :class:`PSpec` tree matching a parameter tree (tensors, meta
    tensors or ``ParamSpec``s: anything with ``.shape``)."""
    def one(keys, leaf):
        shape = tuple(leaf.shape)
        stacked, rule = param_logical(keys, len(shape))
        core = shape[1:] if stacked else shape
        spec = PSpec() if rule is None else _resolve(core, rule, mesh, rules)
        if stacked and len(spec) > 0:
            spec = PSpec(None, *spec)
        return spec
    return map_with_paths(params_shape, one)


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------
def cache_pspecs(cache_spec: PyTree, ctx) -> PyTree:
    """KV/state caches: batch over batch_axes; the sequence dim (dim 1 of
    4-D k/v and 3-D ckv/krope leaves) over seq_axis when divisible."""
    b = ctx.bspec
    seq = ctx.seq_axis if ctx.shard_kv_seq else None
    seq_size = ctx.axis_size(ctx.seq_axis)
    bsize = ctx.dp_size

    def one(keys, leaf):
        stacked = "blocks" in keys
        name = keys[-1]
        shape = tuple(leaf.shape)[1:] if stacked else tuple(leaf.shape)
        bdim = b if shape[0] % max(bsize, 1) == 0 and bsize > 1 else None
        if name in ("k", "v", "ckv", "krope"):
            sdim = seq if seq and shape[1] % seq_size == 0 else None
            spec = (bdim, sdim) + (None,) * (len(shape) - 2)
        else:
            spec = (bdim,) + (None,) * (len(shape) - 1)
        if stacked:
            spec = (None,) + spec
        return PSpec(*spec)
    return map_with_paths(cache_spec, one)


def spec_axes(spec: PSpec) -> Tuple[str, ...]:
    """The mesh axes ``spec`` cuts its leaf over, in its dims' order."""
    out: list = []
    for e in spec:
        for a in ((e,) if isinstance(e, str) else e or ()):
            if a not in out:
                out.append(a)
    return tuple(out)


def batch_pspec(ctx, global_batch: int) -> PSpec:
    if ctx.dp_size > 1 and global_batch % ctx.dp_size == 0:
        return PSpec(ctx.bspec)
    return PSpec(None)


# ---------------------------------------------------------------------------
# Placing: this rank's block of each leaf
# ---------------------------------------------------------------------------
def local_shape(shape, spec: PSpec, ctx) -> Tuple[int, ...]:
    """The shape of this rank's block of a ``shape`` leaf under ``spec``."""
    return tuple(s // ctx.axis_size(spec.entry(i))
                 for i, s in enumerate(shape))


def take_local(t: torch.Tensor, spec: PSpec, ctx) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: a copy when any dim is
    sharded, so the full tensor can be freed."""
    out = t
    for dim in range(t.dim()):
        out = ctx.take_block(out, dim, spec.entry(dim))
    return out.clone() if out.shape != t.shape else t


def shard_tree(tree: PyTree, specs: PyTree, ctx) -> PyTree:
    """``tree``'s leaves cut to this rank's blocks under ``specs``."""
    flat_specs = leaves_by_path(specs)
    return map_with_paths(tree, lambda k, t: take_local(t, flat_specs[k], ctx))


def gather_local(t: torch.Tensor, spec: PSpec, ctx, dims=None):
    """The full leaf from this rank's block: an all-gather over each
    sharded dim (of ``dims``, default every dim) in turn."""
    for dim in range(t.dim()) if dims is None else dims:
        e = spec.entry(dim)
        if e is not None and ctx.axis_size(e) > 1:
            t = ctx.all_gather(t, e, dim=dim)
    return t


def spec_tree_map(fn, tree: PyTree, specs: PyTree) -> PyTree:
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    flat_specs = leaves_by_path(specs)
    return map_with_paths(tree, lambda k, t: fn(t, flat_specs[k]))


__all__ = ["LOGICAL_RULES", "DECODE_RULES", "PARAM_RULES", "PSpec",
           "param_pspecs", "cache_pspecs", "batch_pspec", "shard_tree",
           "take_local", "gather_local", "local_shape", "spec_tree_map",
           "map_with_paths", "leaves_by_path", "spec_axes"]
