"""Step functions (train / prefill / serve), as the launchers run them.

The reference's ``derive_ctx``, ``input_specs``, ``input_shardings``
and ``memory_spec`` describe the inputs to a device mesh for its
dry-run and sharding; the port runs on one device and has none of them
yet.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import train_step


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
