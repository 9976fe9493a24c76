"""GPTQ with Hessian-guided compensation (§4.7).

Row-by-row quantization of a weight [in, out]: after input row i is
rounded, its error is spread over the rows not yet rounded, weighted by
the Cholesky factor of the inverse Hessian ``H = 2 XᵀX`` of the
calibration activations. The steps are the JAX package's, which runs
them in numpy float64 on the host; here they run in torch float64 on the
weight's device, so at d 7168 the row loop's updates stay in device
memory.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.quant.int8 import QTensor


def hessian_from_calibration(x: torch.Tensor,
                             damp: float = 0.01) -> torch.Tensor:
    """x [n, in] calibration activations → damped Hessian [in, in] f64."""
    xf = x.double()
    h = 2.0 * xf.T @ xf
    mean_diag = float(torch.mean(torch.diagonal(h))) or 1.0
    h.diagonal().add_(damp * mean_diag)
    return h


def gptq_quantize(w: torch.Tensor, hessian: Optional[torch.Tensor] = None,
                  block: int = 32) -> Tuple[QTensor, float]:
    """w [in, out] → (channel-wise QTensor, relative error). ``block`` is
    accepted for the reference's signature and unused there too."""
    w64 = w.double()
    wf = w64.clone()
    n_in, n_out = wf.shape
    if hessian is None:
        hessian = torch.eye(n_in, dtype=torch.float64, device=w.device)
    hessian = torch.as_tensor(hessian, dtype=torch.float64, device=w.device)
    # per-output-channel scale fixed up front (symmetric int8)
    # (a tensor divisor: the card divides as the CPU does, see int8.py)
    amax = torch.clamp(wf.abs().amax(dim=0), min=1e-8)
    scale = amax / torch.full_like(amax, 127.0)

    hinv = torch.linalg.inv(hessian)
    # the Cholesky factor of the inverse Hessian gives the update factors
    L, info = torch.linalg.cholesky_ex(hinv)
    if int(info) != 0:
        L = torch.linalg.cholesky(
            hinv + 1e-6 * torch.eye(n_in, dtype=torch.float64,
                                    device=w.device))
    q = torch.zeros_like(wf)
    diag = torch.clamp(torch.diagonal(L), min=1e-12)
    for i in range(n_in):
        col = wf[i]
        qi = torch.clamp(torch.round(col / scale), -127, 127)
        q[i] = qi
        e = (col - qi * scale) / diag[i]
        if i + 1 < n_in:
            # Hessian-guided compensation of the remaining rows
            wf[i + 1:] -= torch.outer(L[i + 1:, i], e)
    deq = q * scale[None, :]
    rel = float(torch.linalg.norm(w64 - deq)
                / max(float(torch.linalg.norm(w64)), 1e-12))
    return QTensor(q.to(torch.int8), scale.float()), rel


def calibrate_moe(samples: torch.Tensor, expert_assign,
                  n_experts: int, min_per_expert: int = 4) -> torch.Tensor:
    """§4.7: expert activations vary with input data; scale the
    calibration set so each expert sees ≥ ``min_per_expert`` samples.
    Returns per-expert sample indices [E, min_per_expert] (repeating if
    needed), drawn as the reference draws them."""
    idx = []
    assign = torch.as_tensor(expert_assign).cpu().numpy()
    rng = np.random.default_rng(0)
    for e in range(n_experts):
        mine = np.where(assign == e)[0]
        if len(mine) == 0:
            mine = rng.integers(0, len(assign), size=min_per_expert)
        reps = -(-min_per_expert // len(mine))
        idx.append(np.tile(mine, reps)[:min_per_expert])
    return torch.as_tensor(np.stack(idx), device=samples.device)
