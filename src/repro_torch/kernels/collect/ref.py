"""Plain PyTorch version of the EPLB Collect histogram.

The JAX package's ``collect_ref`` as written: a one-hot compare of each
id against ``0..E-1``, masked by ``id >= 0``, summed in int32 — so ids
below 0 and ids at ``E`` or above count nowhere.
"""
from __future__ import annotations

import torch


def collect_ref(expert_ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """expert_ids [N] int (-1 = padding) → counts [n_experts] int32."""
    valid = expert_ids >= 0
    onehot = ((expert_ids[:, None] == torch.arange(
        n_experts, device=expert_ids.device)[None, :]) & valid[:, None])
    return onehot.sum(dim=0, dtype=torch.int32)
