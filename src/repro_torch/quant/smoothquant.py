"""SmoothQuant smoothing (§4.7).

Activations have a 10-100× wider dynamic range than weights (paper
Fig. 15). Smoothing moves the difficulty from activations to weights:
per input channel j, ``s_j = max|X_j|^α / max|W_j|^(1-α)``; the layer
computes ``(X / s) @ (diag(s) W)``, the same product in exact arithmetic
but with flattened activation outliers.
"""
from __future__ import annotations

import torch


def smoothing_scales(act_amax: torch.Tensor, w: torch.Tensor,
                     alpha: float = 0.5) -> torch.Tensor:
    """act_amax [in]: calibration max |activation| per input channel;
    w [in, out]. Returns s [in] f32."""
    w_amax = w.float().abs().amax(dim=1)
    s = (torch.clamp(act_amax, min=1e-5) ** alpha
         / torch.clamp(w_amax, min=1e-5) ** (1 - alpha))
    return torch.clamp(s, 1e-4, 1e4)


def apply_smoothing(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Fold s into the weight: ``W' = diag(s) @ W`` (the activation side,
    ``X / s``, folds into the preceding RMSNorm scale in deployment)."""
    return (w.float() * s[:, None]).to(w.dtype)


def calibrate_act_amax(samples: torch.Tensor) -> torch.Tensor:
    """samples [n, in] calibration activations → max |x| per channel."""
    return samples.float().abs().amax(dim=0)


def smooth_quant_pair(samples: torch.Tensor, w: torch.Tensor,
                      alpha: float = 0.5):
    """Returns (smoothed weight, activation divisor s)."""
    s = smoothing_scales(calibrate_act_amax(samples), w, alpha)
    return apply_smoothing(w, s), s
