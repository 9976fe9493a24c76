"""Step functions (train / prefill / serve), as the launchers run them,
and their inputs on a mesh: ``derive_ctx`` (the batch axes and MoE
strategy of an input shape), ``input_specs`` (shape and dtype stand-ins,
``meta`` tensors) and ``input_shardings`` (their specs).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import sharding as shd
from repro_torch.models.mesh_ctx import MeshCtx
from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import train_step


def derive_ctx(mesh, shape: InputShape, cfg: ModelConfig,
               multi_pod: bool, **overrides) -> MeshCtx:
    """Pick batch axes (largest prefix of (pod, data) that divides the
    global batch) and the MoE strategy for this input shape."""
    candidates = ("pod", "data") if multi_pod else ("data",)
    batch_axes = ()
    b = shape.global_batch
    for i in range(len(candidates), 0, -1):
        axes = candidates[:i] if multi_pod else candidates
        prod = 1
        for a in axes:
            prod *= mesh.shape[a]
        if b % prod == 0:
            batch_axes = tuple(axes)
            break
        if not multi_pod:
            break
    kw = dict(
        mesh=mesh,
        batch_axes=batch_axes,
        moe_impl="gather" if shape.kind == "decode" else "alltoall",
        remat="full" if shape.kind == "train" else "none",
    )
    kw.update(overrides)
    return MeshCtx(**kw)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def memory_spec(cfg: ModelConfig, batch: int) -> Optional[torch.Tensor]:
    if cfg.family == "vlm":
        return _meta((batch, cfg.num_frontend_tokens, cfg.d_model),
                     torch.bfloat16)
    if cfg.is_encdec:
        return _meta((batch, cfg.num_frontend_tokens,
                      cfg.encoder_d_model or cfg.d_model), torch.bfloat16)
    return None


def input_specs(cfg: ModelConfig, shape: InputShape, model: Model,
                ctx: MeshCtx) -> Dict[str, Any]:
    """``meta``-tensor stand-ins for every model input of this shape."""
    B, S = shape.global_batch, shape.seq_len
    mem = memory_spec(cfg, B)
    if shape.kind == "train":
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        if mem is not None:
            batch["memory"] = mem
        return {"batch": batch}
    if shape.kind == "prefill":
        out = {"tokens": _meta((B, S), torch.int32)}
        if mem is not None:
            out["memory"] = mem
        return out
    # decode: one new token against a seq_len cache
    return {"cache": model.cache_spec(B, S),
            "tokens": _meta((B, 1), torch.int32),
            "positions": _meta((B,), torch.int32)}


def input_shardings(cfg: ModelConfig, shape: InputShape, model: Model,
                    ctx: MeshCtx) -> Dict[str, Any]:
    """The specs of :func:`input_specs`' leaves."""
    bs = shd.batch_pspec(ctx, shape.global_batch)
    mem = shd.PSpec(*(tuple(bs) + (None, None)))
    if shape.kind == "train":
        batch = {"tokens": bs, "labels": bs}
        if memory_spec(cfg, shape.global_batch) is not None:
            batch["memory"] = mem
        return {"batch": batch}
    if shape.kind == "prefill":
        out = {"tokens": bs}
        if memory_spec(cfg, shape.global_batch) is not None:
            out["memory"] = mem
        return out
    return {"cache": shd.cache_pspecs(
                model.cache_spec(shape.global_batch, shape.seq_len), ctx),
            "tokens": bs, "positions": bs}


def make_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None):
    """→ ``train_step(params, opt_state, batch)`` → (params, opt_state,
    metrics); ``batch``: ``tokens``, ``labels`` and optionally
    ``memory``."""
    opt_cfg = opt_cfg or AdamWConfig()

    def step(params, opt_state, batch):
        return train_step(model, opt_cfg, params, opt_state,
                          batch["tokens"], batch["labels"],
                          memory=batch.get("memory"))
    return step


def make_prefill_step(model: Model):
    def prefill_step(params, tokens, memory=None):
        return model.prefill(params, tokens, memory=memory)
    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, tokens, positions):
        return model.decode_step(params, cache, tokens, positions)
    return serve_step
