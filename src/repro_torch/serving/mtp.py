"""Multi-Token Prediction speculative decoding (§4.6), batch 1.

The five-step loop:
  (1) MTP forward → a draft token, (2) sample the draft, (3) verify with
  the main model, (4) sample from the main outputs, (5) accept-check.

Per decode iteration the engine advances by 1 + (accepted drafts) tokens;
with the paper's ~90% single-layer acceptance the effective TPOT is
iteration time / 1.9 (§7.1). The batched engine path is
:meth:`~repro_torch.serving.backend.TorchBackend.decode_sample_mtp`;
:class:`MTPDecoder` is the single-sequence greedy loop.
:class:`MTPTrainer` implements §4.6 "Multiple MTPs": training one MTP
layer with the main model and the other heads frozen.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_unflatten_like
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


# ---------------------------------------------------------------------------
# §4.6 "Multiple MTPs": train one MTP layer with everything else frozen
# ---------------------------------------------------------------------------
class MTPTrainer:
    """Plain SGD (``p - lr · g``, the gradient cast to the parameter's
    dtype) on head ``mtp_index`` alone, teacher-forced on the main
    stack's final hidden states: head position ``t`` predicts token
    ``t + 2`` from hidden ``t`` and token ``t + 1``. The loss depends on
    no other weight's gradient, so the frozen stack runs under
    ``torch.no_grad()`` and keeps no activations."""

    def __init__(self, model: Model, params: PyTree, mtp_index: int,
                 lr: float = 1e-3):
        self.model = model
        self.mtp_index = mtp_index
        self.lr = lr
        self.params = params

    def train_step(self, tokens: torch.Tensor) -> float:
        """tokens [B, S] int on the params' device → the step's loss
        (before the update)."""
        from repro_torch.train.train_loop import grads_of

        model, params, idx = self.model, self.params, self.mtp_index
        tokens = tokens.long()
        ctx, rows = model._batch_ctx(tokens.shape[0])
        mine, labels = model._rows(ctx, rows, tokens, tokens[:, 2:])
        with torch.no_grad():
            x, sp = model._residual_constraint(
                model._embed(params, mine, ctx), "train", ctx)
            x, _, _ = model._apply_stack(params, x, mode="train", ctx=ctx,
                                         sp_axis=sp)
        head = params["mtp"][idx]
        leaves = [t.detach().requires_grad_() for t in tree_leaves(head)]
        mtps = list(params["mtp"])
        mtps[idx] = tree_unflatten_like(head, leaves)
        h, _ = model.mtp_hidden(dict(params, mtp=tuple(mtps)), idx,
                                x[:, :-2], tokens[:, 1:-1], None)
        loss, _ = model.train_nll(params, h, labels, None, ctx)
        grads = tree_leaves(grads_of(model, loss, leaves, head,
                                     model.specs["mtp"][idx]))
        with torch.no_grad():
            new = [p - self.lr * g.to(p.dtype)
                   for p, g in zip(tree_leaves(head), grads)]
        mtps[idx] = tree_unflatten_like(head, new)
        self.params = dict(params, mtp=tuple(mtps))
        return float(loss.detach())
