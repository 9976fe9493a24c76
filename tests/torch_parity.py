"""Helpers for the parity tests of the PyTorch port (``tests/test_torch_*``).

The JAX reference is built on a 1×1 mesh with Auto axes (the smoke
context's Explicit axes make the reference's MoE/MLA decode raise under
current JAX), and its weights reach the port as numpy arrays through
``repro_torch.models.weights.from_jax_params``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.mesh_ctx import MeshCtx
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models.weights import from_jax_params

ARCH = "deepseek-v3-671b-smoke"
#: named smoke configurations: registry name and field overrides. The
#: Llama-4 one has G = 5 query heads per KV head, as at full width (the
#: plain smoke variant has G = 1).
CONFIGS = {
    "deepseek-v3": (ARCH, {}),
    "llama4-gqa": ("llama4-maverick-400b-a17b-smoke",
                   {"num_heads": 10, "num_kv_heads": 2, "head_dim": 32}),
}


def auto_ctx(**kw) -> MeshCtx:
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return MeshCtx(mesh=mesh, batch_axes=("data",), remat="none", **kw)


def configs(dtype: str = "float32", num_layers=None,
            config: str = "deepseek-v3"):
    """(JAX config, port config) of a smoke configuration of
    :data:`CONFIGS`, equal fields."""
    arch, kw = CONFIGS[config]
    kw = dict(kw, dtype=dtype)
    if num_layers is not None:
        kw["num_layers"] = num_layers
    return (dataclasses.replace(jax_get_config(arch), **kw),
            dataclasses.replace(torch_get_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def reference(dtype: str = "float32", num_layers=None, seed: int = 0,
              config: str = "deepseek-v3"):
    """(jax cfg, jax model, jax params, port cfg, port params on CPU),
    the MTP head included where the configuration has one."""
    jcfg, tcfg = configs(dtype, num_layers, config)
    model = jax_build_model(jcfg, auto_ctx())
    params = model.init(jax.random.PRNGKey(seed))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, "cpu")
    return jcfg, model, params, tcfg, tparams


def to_np(x) -> np.ndarray:
    """A JAX array or a torch tensor as a float32/int numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def rel_err(a, b) -> float:
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))
