"""On-device token sampling for the zero-sync decode fast path.

The decode loop never ships logits back to the host: sampling runs on
the device right after the forward, and only the chosen token ids
(``[B]`` int32 — 4 bytes per slot) cross to the host per iteration.
:func:`sample_tokens` is the batch sampler the
:class:`~repro_torch.serving.backend.TorchBackend` runs inside its
decode step; :func:`sample_host` is the numpy version used for parity
tests (greedy exact-match; stochastic paths checked as distributions).

Semantics (per slot ``i``):

* ``temperatures[i] <= 0``  → greedy ``argmax`` (first index on ties).
* ``temperatures[i] > 0``   → Gumbel-max categorical over
  ``logits / temperature``, optionally truncated to the ``top_k``
  highest logits (``top_k=0`` disables truncation). The Gumbel noise
  comes from an explicit ``torch.Generator``; it does not reproduce the
  JAX package's draws, only their distribution.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The sampling stream of one engine iteration: a pure function of
    ``(seed, step)``, so a replayed step draws the same noise."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (1 << 63))
    return gen


def top_k_mask(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Mask logits below the k-th largest per row to ``NEG_INF``."""
    if top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits,
                       torch.full_like(logits, NEG_INF))


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    e = -torch.log(u.clamp(min=tiny))           # Exp(1)
    return -torch.log(e.clamp(min=tiny))


def sample_tokens(logits: torch.Tensor, temperatures: torch.Tensor,
                  generator: torch.Generator, *,
                  top_k: int = 0) -> torch.Tensor:
    """logits [B, V] f32, temperatures [B] f32 → token ids [B] int32."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.clamp(temperatures.float(), min=1e-6)[:, None]
    g = gumbel(logits.shape, generator, logits.device)
    stoch = torch.argmax(top_k_mask(logits, top_k) / t + g,
                         dim=-1).to(torch.int32)
    return torch.where(temperatures <= 0.0, greedy, stoch)


def sample_host(logits: np.ndarray, temperature: float,
                rng: Optional[np.random.Generator] = None,
                *, top_k: int = 0) -> int:
    """Numpy version of :func:`sample_tokens` for one row."""
    logits = np.asarray(logits, np.float32)
    if temperature <= 0.0:
        return int(np.argmax(logits))
    if rng is None:
        rng = np.random.default_rng(0)
    masked = logits.copy()
    if 0 < top_k < logits.shape[-1]:
        kth = np.sort(logits)[-top_k]
        masked[masked < kth] = NEG_INF
    g = rng.gumbel(size=masked.shape)
    return int(np.argmax(masked / max(temperature, 1e-6) + g))
