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
import pytest
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
    # a second MTP head, the one ``MTPTrainer`` trains in the reference's
    # own test
    "deepseek-v3-mtp2": (ARCH, {"mtp_num_layers": 2}),
    "llama4-gqa": ("llama4-maverick-400b-a17b-smoke",
                   {"num_heads": 10, "num_kv_heads": 2, "head_dim": 32}),
    "llama4": ("llama4-maverick-400b-a17b-smoke", {}),
    "internlm2": ("internlm2-1.8b-smoke", {}),
    # one superblock (RG-LRU, RG-LRU, ring-window attention) and a
    # 2-layer RG-LRU tail
    "recurrentgemma": ("recurrentgemma-2b-smoke", {"num_layers": 5}),
    "mamba2": ("mamba2-130m-smoke", {}),
    # one superblock of 4 ATTN layers and a CROSS_ATTN layer; the GQA
    # variant has G = 4 query heads per KV head, as at full width
    "vision": ("llama-3.2-vision-11b-smoke", {}),
    "vision-gqa": ("llama-3.2-vision-11b-smoke",
                   {"num_heads": 8, "num_kv_heads": 2}),
    # with an MTP head, whose block takes global attention in place of
    # the pattern's last (cross-attention) mixer
    "vision-mtp": ("llama-3.2-vision-11b-smoke", {"mtp_num_layers": 1}),
    # a 2-block encoder, then (ATTN, NONE), (CROSS_ATTN, MLP)
    "seamless": ("seamless-m4t-medium-smoke", {}),
    # the dense GQA models at their full-width G: 4 query heads per KV
    # head (Granite, Mistral-NeMo), 8 and the tied head (Command-R)
    "granite": ("granite-8b-smoke", {"num_heads": 8, "num_kv_heads": 2}),
    "mistral-nemo": ("mistral-nemo-12b-smoke",
                     {"num_heads": 8, "num_kv_heads": 2}),
    "command-r": ("command-r-35b-smoke",
                  {"num_heads": 16, "num_kv_heads": 2, "head_dim": 32}),
    # MHA, a dense prefix layer, then a top-2 MoE layer with a shared
    # expert
    "deepseek-moe": ("deepseek-moe-16b-smoke", {}),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's small CPU ops in one thread for the importing test
    module (autouse where imported): the suite runs several test
    processes at once, and a pool of spinning threads in each then slows
    every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
              config: str = "deepseek-v3", jit_init: bool = False):
    """(jax cfg, jax model, jax params, port cfg, port params on CPU),
    the MTP head included where the configuration has one. ``jit_init``:
    the reference's ``init`` under ``jax.jit``, one compiled program in
    place of hundreds of eager ops (its draws agree with the eager ones
    to the last bit or two)."""
    jcfg, tcfg = configs(dtype, num_layers, config)
    model = jax_build_model(jcfg, auto_ctx())
    init = jax.jit(model.init) if jit_init else model.init
    params = init(jax.random.PRNGKey(seed))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              tcfg, "cpu")
    return jcfg, model, params, tcfg, tparams


def jax_engine(model, params, *, max_len: int = 256, mtp_k: int = 0,
               **kw):
    """The reference's ``FlowServeEngine`` on the Auto-axis mesh whose DP
    groups share one ``JAXBackend``, so that its programs are traced and
    compiled once, not once a group. A backend keeps no state of its
    group but its sampling seed (greedy serving never draws) and the
    placement, which EPLB installs in every group alike."""
    from repro.serving.backend import JAXBackend
    from repro.serving.flowserve import FlowServeEngine

    be = JAXBackend(model, params, max_len=max_len, mtp_k=mtp_k)
    return FlowServeEngine(model.cfg, params, ctx=auto_ctx(),
                           max_len=max_len, mtp_k=mtp_k,
                           backend_factory=lambda dp_id: be, **kw)


def memory(cfg, batch: int = 1, length=None, seed: int = 0) -> np.ndarray:
    """A seeded memory for a model with cross-attention, float32 [batch,
    length (default ``num_frontend_tokens``), md]: a VLM's patch
    embeddings or an encoder-decoder's frames (both frontends are stubs
    in the reference)."""
    md = cfg.encoder_d_model or cfg.d_model
    return np.random.default_rng(seed).standard_normal(
        (batch, length or cfg.num_frontend_tokens, md)).astype(np.float32)


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


#: one row of every kind ``SuperPodCostModel.from_calibration`` reads,
#: two points of each curve, values outside [0, 1] where it clips, and
#: one row it does not know (ignored)
SIM_CALIBRATION_ROWS = [
    {"name": "fig6/dispatch/bpd8", "us_per_call": 100.0,
     "derived": "combine_us=150.0"},
    {"name": "fig6/dispatch/bpd96", "us_per_call": 300.0,
     "derived": "combine_us=400.0 extra=1"},
    {"name": "fig6/dispatch/bpd32", "us_per_call": 180.0, "derived": ""},
    {"name": "decode/iter_overhead", "us_per_call": 512.25, "derived": ""},
    {"name": "disagg/expert_op_overhead", "us_per_call": 33.5,
     "derived": ""},
    {"name": "prefill/chunk_time/c2048", "us_per_call": 41000.0,
     "derived": ""},
    {"name": "prefill/chunk_time/c512", "us_per_call": 12000.0,
     "derived": ""},
    {"name": "prefill/decode_contention", "us_per_call": 1.37,
     "derived": "dimensionless"},
    {"name": "prefill/hit_skip", "us_per_call": 0.6036,
     "derived": "dimensionless"},
    {"name": "prefix/remote_seed", "us_per_call": 1.7,
     "derived": "dimensionless, clipped to 1"},
    {"name": "mtp/acceptance", "us_per_call": -0.2,
     "derived": "dimensionless, clipped to 0"},
    {"name": "mtp/draft_overhead", "us_per_call": 2500.0, "derived": ""},
    {"name": "eplb/placement_gmm", "us_per_call": 50.0, "derived": ""},
    {"name": "not/a/row", "us_per_call": 9.0, "derived": ""},
]


def write_sim_calibration(directory) -> tuple:
    """:data:`SIM_CALIBRATION_ROWS` split over two files (the row order
    inside a curve is not sorted), as ``SimConfig.calibration_paths``
    takes them."""
    import json
    from pathlib import Path

    half = len(SIM_CALIBRATION_ROWS) // 2
    paths = []
    for i, rows in enumerate((SIM_CALIBRATION_ROWS[:half],
                              SIM_CALIBRATION_ROWS[half:])):
        p = Path(directory) / f"calibration{i}.json"
        p.write_text(json.dumps({"benchmark": "sim", "rows": rows}))
        paths.append(str(p))
    return tuple(paths)
