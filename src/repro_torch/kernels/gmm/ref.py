"""Plain PyTorch version of the grouped expert FFN (SwiGLU).

Computed in float32 throughout with no cast of the hidden, like the JAX
package's ``gmm_ref``: the CPU model runs this, which keeps it within
float rounding of the JAX model on the CPU. The work is split over
groups of slots so that the float32 copies of the weights stay small at
DeepSeek-V3 width (256 experts of 7168 × 2048 would be 45 GB at once).
"""
from __future__ import annotations

import torch

_GROUP = 16     # slots per float32 weight copy


def _ffn(x, wg, wu, wd):
    g = torch.einsum("ecd,edf->ecf", x, wg.float())
    u = torch.einsum("ecd,edf->ecf", x, wu.float())
    h = g * torch.sigmoid(g) * u          # SiLU(g) * u
    return torch.einsum("ecf,efd->ecd", h, wd.float())


def gmm_ref(buckets, we_gate, we_up, we_down):
    """buckets [E, C, d]; we_gate/we_up [E, d, f]; we_down [E, f, d]
    → [E, C, d] f32."""
    x = buckets.float()
    return torch.cat([_ffn(x[s:s + _GROUP], we_gate[s:s + _GROUP],
                           we_up[s:s + _GROUP], we_down[s:s + _GROUP])
                      for s in range(0, x.shape[0], _GROUP)], dim=0)


def placement_gmm_ref(buckets, we_gate, we_up, we_down, phys_owner):
    """Owner-indexed version: physical slot ``s`` computes against
    expert ``phys_owner[s]``'s weights (the owner-gathered path)."""
    x = buckets.float()
    o = phys_owner.long()
    out = []
    for s in range(0, x.shape[0], _GROUP):
        og = o[s:s + _GROUP]
        out.append(_ffn(x[s:s + _GROUP], we_gate[og], we_up[og],
                        we_down[og]))
    return torch.cat(out, dim=0)


def live_rows(buckets):
    """[S, C, d] → [S] int32: 1 + the index of the last row of each slot
    with a non-zero element, 0 for an empty slot. -0.0 counts as zero,
    NaN and inf as non-zero. The CUDA kernel computes this on the card
    and runs only these rows: an all-zero row gives +0 in every output
    element, which is what it writes for the rows past them."""
    S, C, _ = buckets.shape
    nz = (buckets != 0).any(dim=-1)                          # [S, C]
    idx = torch.arange(1, C + 1, device=buckets.device)
    last = torch.zeros((S, 1), dtype=idx.dtype, device=buckets.device)
    return torch.cat([last, nz * idx], dim=1).amax(dim=1).to(torch.int32)
