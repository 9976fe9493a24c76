"""Weight bridge: numpy leaves of the JAX package's ``Model.init`` tree →
the port's parameter tree, one to one by path.

The JAX tree is handed over as numpy arrays (``tree_map(np.asarray,
params)`` on the JAX side), so this module needs neither JAX nor the JAX
package. Paths are dotted (``prefix.0.mixer.wq_a``,
``blocks.pos0.ffn.we_gate`` stacked ``[n_sb, ...]``, ``embed``,
``final_norm``, ``lm_head``, the MTP head's ``mtp.0.proj``,
``mtp.0.block.mixer.wq_a``). A missing or unexpected leaf, or a shape or
dtype mismatch, raises.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import Model

def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """Dotted path → leaf for a tree of dicts and tuples/lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, object] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _unflatten_like(spec, leaves: Dict[str, torch.Tensor], prefix=""):
    if isinstance(spec, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}.{k}" if prefix
                                   else str(k)) for k, v in spec.items()}
    if isinstance(spec, tuple) and not hasattr(spec, "_fields"):
        return tuple(_unflatten_like(v, leaves, f"{prefix}.{i}" if prefix
                                     else str(i)) for i, v in enumerate(spec))
    return leaves[prefix]


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bf16: reinterpret bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_jax_params(tree, cfg: ModelConfig, device="cuda") -> Dict:
    """Map the JAX reference's parameter tree (numpy leaves) onto the
    port's parameter tree on ``device``."""
    dev = resolve_device(device)
    spec = Model(cfg).param_spec()
    want = flatten(spec)
    got = flatten(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"weight bridge: missing {missing}, unexpected {extra}")
    leaves = {}
    for path, s in want.items():
        t = _to_torch(np.asarray(got[path]))
        if tuple(t.shape) != tuple(s.shape) or t.dtype != s.dtype:
            raise ValueError(f"weight bridge: {path} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {s.shape} {s.dtype}")
        leaves[path] = t.to(dev)
    return _unflatten_like(spec, leaves)
