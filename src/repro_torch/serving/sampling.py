"""On-device token sampling for the zero-sync decode fast path.

The decode loop never ships logits back to the host: sampling runs on
the device right after the forward, and only the chosen token ids
(``[B]`` int32 — 4 bytes per slot) cross to the host per iteration.
:func:`sample_tokens` is the batch sampler the
:class:`~repro_torch.serving.backend.TorchBackend` runs inside its
decode step; :func:`speculative_verify` is the §4.6 MTP acceptance step
of its propose-then-verify iteration; :func:`sample_host` is the numpy
version used for parity tests (greedy exact-match; stochastic paths
checked as distributions).

Semantics (per slot ``i``):

* ``temperatures[i] <= 0``  → greedy ``argmax`` (first index on ties).
* ``temperatures[i] > 0``   → Gumbel-max categorical over
  ``logits / temperature``, optionally truncated to the ``top_k``
  highest logits (``top_k=0`` disables truncation). The Gumbel noise
  comes from an explicit ``torch.Generator``; it does not reproduce the
  JAX package's draws, only their distribution.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30
#: the draw streams of one MTP iteration (stream 0 is the one-token
#: sampler's): the drafts, the acceptance uniforms, the residual
#: resamples and the bonus token each draw from their own generator
DRAFT, ACCEPT, RESIDUAL, BONUS = 1, 2, 3, 4


def step_generator(seed: int, step: int, device,
                   stream: int = 0) -> torch.Generator:
    """The sampling stream ``stream`` of one engine iteration: a pure
    function of ``(seed, step, stream)``, so a replayed step draws the
    same noise."""
    gen = torch.Generator(device=device)
    base = int(seed) * 1_000_003 + int(step)
    gen.manual_seed((base + stream * 0x9E3779B97F4A7C15) % (1 << 63))
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


def greedy_verify(main_logits: torch.Tensor, draft_tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy MTP acceptance: ``main_logits`` [B, k+1, V] (row ``j`` the
    main model's logits after the token at launch position + ``j``),
    ``draft_tokens`` [B, k] → (argmax tokens [B, k+1] int32, accepted
    drafts [B] int32): draft ``j`` counts while every draft up to it
    equals the main model's argmax, and every emitted token is that
    argmax, so the stream equals plain greedy decoding."""
    greedy = torch.argmax(main_logits.float(), dim=-1).to(torch.int32)
    k = draft_tokens.shape[1]
    acc = (draft_tokens == greedy[:, :k]).to(torch.int32)
    return greedy, torch.cumprod(acc, dim=1).sum(dim=1).to(torch.int32)


def speculative_verify(main_logits: torch.Tensor, draft_tokens: torch.Tensor,
                       draft_logits: torch.Tensor, temperatures: torch.Tensor,
                       seed: int, step: int, *, top_k: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Propose-then-verify acceptance of MTP speculative decoding (§4.6).

    ``main_logits`` [B, k+1, V] as in :func:`greedy_verify`;
    ``draft_tokens`` [B, k] and ``draft_logits`` [B, k, V] the head's
    proposals and the logits they were drawn from. Returns ``(tokens
    [B, k+1] int32, n_accepted [B] int32)``: slot ``i`` emits
    ``tokens[i, :n_accepted[i] + 1]``; entries past that are junk.

    * ``temperatures[i] <= 0``: :func:`greedy_verify`'s rule, exact.
    * ``temperatures[i] > 0``: the rejection rule. Draft ``d ~ q`` is
      accepted with probability ``min(1, p(d) / q(d))``; the first
      rejection is resampled from ``norm(max(p - q, 0))``; when all
      ``k`` are accepted a bonus token is drawn from the last row's
      ``p``. Each emitted token is distributed as ``p``; at ``k = 0``
      this is plain sampling from ``p``.

    ``p`` and ``q`` are softmax over ``top_k_mask(logits, top_k) / t``,
    the transform :func:`sample_tokens` draws the drafts with. The
    acceptance, residual and bonus draws come from their own streams of
    ``(seed, step)``, so re-executing a step replays them.
    """
    B, k1, V = main_logits.shape
    k = k1 - 1
    dev = main_logits.device
    greedy, n_greedy = greedy_verify(main_logits, draft_tokens)
    t = torch.clamp(temperatures.float(), min=1e-6)[:, None, None]
    p = torch.softmax(top_k_mask(main_logits.float(), top_k) / t, dim=-1)
    q = torch.softmax(top_k_mask(draft_logits.float(), top_k) / t, dim=-1)
    drafts = draft_tokens.long()[..., None]
    p_d = torch.gather(p[:, :k], -1, drafts)[..., 0]
    q_d = torch.gather(q, -1, drafts)[..., 0]
    u = torch.rand((B, k), generator=step_generator(seed, step, dev, ACCEPT),
                   device=dev, dtype=torch.float32)
    acc = u < torch.clamp(p_d / torch.clamp(q_d, min=1e-20), max=1.0)
    n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)
    # the residual norm(max(p - q, 0)) at each possible rejection, drawn
    # by Gumbel-max over its log; the bonus token from the last row's p
    resid = torch.clamp(p[:, :k] - q, min=0.0)
    resid_logits = torch.where(resid > 0, torch.log(resid),
                               torch.full_like(resid, NEG_INF))
    resid_tok = torch.argmax(
        resid_logits + gumbel((B, k, V), step_generator(seed, step, dev,
                                                        RESIDUAL), dev),
        dim=-1)
    bonus = torch.argmax(
        torch.log(torch.clamp(p[:, -1], min=1e-38))
        + gumbel((B, V), step_generator(seed, step, dev, BONUS), dev),
        dim=-1)
    pad_draft = torch.cat([draft_tokens.long(),
                           torch.zeros((B, 1), dtype=torch.long,
                                       device=dev)], dim=1)
    resid_or_bonus = torch.cat([resid_tok, bonus[:, None]], dim=1)
    j = torch.arange(k1, device=dev)[None, :]
    stoch = torch.where(j < n_acc[:, None], pad_draft, resid_or_bonus)
    greedy_row = temperatures <= 0.0
    tokens = torch.where(greedy_row[:, None], greedy.long(), stoch)
    n_acc = torch.where(greedy_row, n_greedy, n_acc.to(torch.int32))
    return tokens.to(torch.int32), n_acc.to(torch.int32)


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
