"""Grouped expert FFN entry point.

:func:`expert_ffn` launches the hand-written CUDA kernel for tensors on
the card and takes the plain version (``ref.py``) only for tensors on
the CPU; any other device raises, and a failed build or launch on the
card raises — there is no fallback.

``phys_owner`` switches to the EPLB owner-indexed grouped FFN (§4.5):
buckets are per physical replica slot and slot ``s`` computes against
expert ``phys_owner[s]``'s weights, read in place rather than gathered.
On the card it is bit-identical to ``expert_ffn(buckets,
we_gate[phys_owner], ...)``.
"""
from __future__ import annotations

from repro_torch.kernels.gmm.kernel import gmm_cuda
from repro_torch.kernels.gmm.ref import gmm_ref, placement_gmm_ref


def expert_ffn(buckets, we_gate, we_up, we_down, *, phys_owner=None):
    """buckets [G, C, d] → [G, C, d] f32. With ``phys_owner=None``, G
    indexes the weights directly; with ``phys_owner`` [G] int32, slot
    ``s`` runs against ``we_*[phys_owner[s]]``."""
    if buckets.device.type == "cuda":
        return gmm_cuda(buckets, we_gate, we_up, we_down, phys_owner)
    if buckets.device.type == "cpu":
        if phys_owner is None:
            return gmm_ref(buckets, we_gate, we_up, we_down)
        return placement_gmm_ref(buckets, we_gate, we_up, we_down,
                                 phys_owner)
    raise ValueError(f"gmm: no kernel for device {buckets.device}")
