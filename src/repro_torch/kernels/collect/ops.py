"""EPLB Collect entry point.

:func:`expert_counts` launches the hand-written CUDA kernel for a tensor
on the card and takes the plain version (``ref.py``) only for a tensor on
the CPU; any other device raises, and a failed build or launch on the
card raises — there is no fallback.
"""
from __future__ import annotations

from repro_torch.kernels.collect.kernel import collect_cuda
from repro_torch.kernels.collect.ref import collect_ref


def expert_counts(expert_ids, *, n_experts: int):
    """expert_ids [N] int32/int64 (-1 = padding) → counts [n_experts]
    int32."""
    if expert_ids.device.type == "cuda":
        return collect_cuda(expert_ids, n_experts)
    if expert_ids.device.type == "cpu":
        return collect_ref(expert_ids, n_experts)
    raise ValueError(f"collect: no kernel for device {expert_ids.device}")
