"""Multi-Token Prediction speculative decoding (§4.6), batch 1.

The five-step loop:
  (1) MTP forward → a draft token, (2) sample the draft, (3) verify with
  the main model, (4) sample from the main outputs, (5) accept-check.

Per decode iteration the engine advances by 1 + (accepted drafts) tokens;
with the paper's ~90% single-layer acceptance the effective TPOT is
iteration time / 1.9 (§7.1). The batched engine path is
:meth:`~repro_torch.serving.backend.TorchBackend.decode_sample_mtp`;
:class:`MTPDecoder` is the single-sequence greedy loop. Training a
second MTP layer (the reference's ``MTPTrainer``) needs autograd
through the model and waits for the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from repro_torch.models.transformer import Model

PyTree = Any


@dataclasses.dataclass
class MTPStats:
    iterations: int = 0
    drafts: int = 0
    accepted: int = 0
    tokens: int = 0

    @property
    def acceptance(self) -> float:
        return self.accepted / max(self.drafts, 1)

    @property
    def tokens_per_step(self) -> float:
        return self.tokens / max(self.iterations, 1)


class MTPDecoder:
    """Speculative greedy decode of a single sequence on the device of
    ``params`` (engine-level batching is the backend's
    ``decode_sample_mtp``)."""

    def __init__(self, model: Model, params: PyTree):
        if "mtp" not in params:
            raise ValueError("model has no MTP head")
        self.model = model
        self.params = params
        self.stats = MTPStats()
        self.device = params["embed"].device

    def _ints(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    @torch.no_grad()
    def generate(self, cache: PyTree, first_token: int, start_pos: int,
                 n_tokens: int) -> Tuple[List[int], PyTree]:
        """Greedy speculative generation of ``n_tokens`` (batch 1; the
        cache is updated in place).

        Each iteration: the MTP head drafts the NEXT token from the last
        accepted token; the main model then runs on the accepted token;
        the draft is accepted iff it equals the main model's argmax
        (lossless), and an accepted draft is committed with one more main
        step and no extra sampling round. The head is conditioned on a
        zero hidden [1, 1, d] for the whole call, as in the reference."""
        model, params = self.model, self.params
        out: List[int] = []
        token, pos = first_token, start_pos
        hid = torch.zeros((1, 1, model.cfg.d_model), dtype=model.dtype,
                          device=self.device)
        while len(out) < n_tokens:
            self.stats.iterations += 1
            # (1)+(2): draft from the MTP head
            tok, p = self._ints([[token]]), self._ints([pos])
            draft_logits, _, _ = model.mtp_step(params, 0, hid, tok, p)
            draft = int(torch.argmax(draft_logits[0]))
            self.stats.drafts += 1
            # (3): verify: the main model consumes `token`
            logits, cache = model.decode_step(params, cache, tok, p)
            token = int(torch.argmax(logits[0]))
            out.append(token)
            self.stats.tokens += 1
            pos += 1
            # (5): acceptance check
            if draft == token and len(out) < n_tokens:
                logits, cache = model.decode_step(
                    params, cache, self._ints([[token]]), self._ints([pos]))
                token = int(torch.argmax(logits[0]))
                out.append(token)
                self.stats.accepted += 1
                self.stats.tokens += 1
                pos += 1
        return out[:n_tokens], cache
