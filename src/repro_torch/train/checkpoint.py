"""Checkpoints: a tree of tensors saved under ``directory/step_N`` with a
manifest, written atomically (a temporary directory renamed into place),
the newest ``keep`` kept — the reference's layout: ``leaves.npz``
(``leaf_i`` in the JAX package's flatten order, bfloat16 widened to
float32, which is lossless) and ``manifest.json`` (the step, each leaf's
``jax.tree_util.keystr`` path, shape and true dtype, the tree's
structure as ``PyTreeDef(...)`` text).

The reference also pickles its JAX treedef (``treedef.pkl``) and
restores through it. The port neither writes nor reads that file: it
restores by the manifest's paths (``[i]`` a tuple index, ``['k']`` a
dict key, ``.field`` a field of :class:`AdamWState`). So the port reads
the reference's checkpoints, and the reference cannot read the port's.

On a mesh (``ctx`` and ``specs``, the tree's ``PSpec``s) a save gathers
every leaf to its global value and the first rank of the context's axes
(``MeshCtx.named_axes``) writes it once, the others waiting for it; a restore reads the global leaves and
cuts this rank's block of each (``launch/sharding.shard_tree``), so a
checkpoint moves between any meshes, one device included.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import resolve_device
from repro_torch.train.optimizer import AdamWState

PyTree = Any
_MANIFEST = "manifest.json"
#: NamedTuples a checkpoint may hold, by name
_NAMED = {"AdamWState": AdamWState}
_KEY = re.compile(r"\[(\d+)\]|\['([^']*)'\]|\.(\w+)")


def _flatten(tree, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(keystr path, leaf) in the JAX package's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], f"{path}[{k!r}]")]
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _structure(tree) -> str:
    """The tree's structure as JAX prints its treedef (``*`` a leaf)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if hasattr(tree, "_fields"):
        return (f"CustomNode(namedtuple[{type(tree).__name__}], ["
                + ", ".join(_structure(v) for v in tree) + "])")
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(storable array, true dtype name): bfloat16 widened to float32."""
    t = t.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy(), name


def _map_specs(fn, tree, specs):
    """``tree`` rebuilt with ``fn(leaf, spec)``; ``specs`` has ``tree``'s
    structure (NamedTuples, here :class:`AdamWState`, are nodes)."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v, sp)
                            for v, sp in zip(tree, specs)))
    if isinstance(tree, (tuple, list)):
        return tuple(_map_specs(fn, v, sp) for v, sp in zip(tree, specs))
    return fn(tree, specs)


def _mesh_barrier(ctx, device) -> None:
    """Every rank of ``ctx``'s axes waits here for the others."""
    ctx.psum(torch.zeros((1,), device=device), ctx.named_axes)


def save_checkpoint(directory: str, step: int, tree: PyTree,
                    keep: int = 3, *, ctx=None, specs: PyTree = None) -> str:
    """Atomic save of a tree (params, optimizer state) under
    ``directory/step_N``; keeps the newest ``keep`` steps. ``ctx`` /
    ``specs``: the leaves are this rank's blocks (see the module
    docstring)."""
    final = os.path.join(directory, f"step_{step:08d}")
    if ctx is not None and ctx.sharded:
        from repro_torch.launch import sharding as shd

        with torch.no_grad():
            tree = _map_specs(lambda t, sp: shd.gather_local(t, sp, ctx),
                              tree, specs)
        if ctx.axis_index(ctx.named_axes) == 0:
            save_checkpoint(directory, step, tree, keep)
        _mesh_barrier(ctx, _flatten(tree)[0][1].device)
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory)
    flat = _flatten(tree)
    arrays = [_to_numpy(t) for _, t in flat]
    np.savez(os.path.join(tmp, "leaves.npz"),
             **{f"leaf_{i}": a for i, (a, _) in enumerate(arrays)})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump({
            "step": step,
            "n_leaves": len(arrays),
            "paths": [p for p, _ in flat],
            "shapes": [list(a.shape) for a, _ in arrays],
            "dtypes": [d for _, d in arrays],
            "treedef": f"PyTreeDef({_structure(tree)})",
        }, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d[5:]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _keys(path: str) -> list:
    """A keystr path → its keys: int (tuple index), str (dict key) or
    ("attr", name) (a NamedTuple field)."""
    keys, pos = [], 0
    for m in _KEY.finditer(path):
        if m.start() != pos:
            raise ValueError(f"checkpoint: cannot read path {path!r}")
        pos = m.end()
        if m.group(1) is not None:
            keys.append(int(m.group(1)))
        elif m.group(2) is not None:
            keys.append(m.group(2))
        else:
            keys.append(("attr", m.group(3)))
    if pos != len(path):
        raise ValueError(f"checkpoint: cannot read path {path!r}")
    return keys


def _build(node):
    """Nested dicts keyed by the parsed keys → dicts, tuples and
    NamedTuples."""
    if not isinstance(node, dict):
        return node
    keys = list(node)
    if all(isinstance(k, int) for k in keys):
        return tuple(_build(node[i]) for i in range(len(keys)))
    if all(isinstance(k, tuple) for k in keys):
        fields = tuple(k[1] for k in keys)
        named = next((t for t in _NAMED.values() if t._fields == fields),
                     None)
        if named is None:
            raise ValueError(f"checkpoint: no NamedTuple with fields "
                             f"{fields}")
        return named(*(_build(node[k]) for k in keys))
    return {k: _build(v) for k, v in node.items()}


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       device="cuda", *, ctx=None, specs: PyTree = None
                       ) -> Tuple[int, PyTree]:
    """→ (step, tree) of ``directory/step_N`` (default the newest), the
    leaves on ``device`` in their saved dtypes. Reads the reference's
    checkpoints too (its ``treedef.pkl`` is not read). ``ctx`` /
    ``specs``: each leaf cut to this rank's block."""
    if ctx is not None and ctx.sharded:
        from repro_torch.launch import sharding as shd

        step, tree = restore_checkpoint(directory, step, device="cpu")
        dev = resolve_device(device)
        return step, _map_specs(
            lambda t, sp: shd.take_local(t, sp, ctx).to(dev), tree, specs)
    dev = resolve_device(device)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    root: Dict = {}
    with np.load(os.path.join(path, "leaves.npz")) as data:
        for i, p in enumerate(manifest["paths"]):
            want = getattr(torch, manifest["dtypes"][i])
            leaf = torch.from_numpy(np.asarray(data[f"leaf_{i}"]).copy())
            node, keys = root, _keys(p)
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = leaf.to(want).to(dev)
    return step, _build(root)
