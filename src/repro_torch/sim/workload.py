"""Deterministic workload generation for the SuperPod simulator.

Poisson arrivals with a two-component prompt-length mix (short chat /
long document, the §7.2 traffic split) and lognormal output lengths.
Every request also carries an *expert-affinity seed*: the sim derives
per-iteration expert routing counts from it, so a skewed corpus (Zipf
``expert_skew``) produces the hot-expert imbalance EPLB exists to fix.
Expert popularity is PER LAYER (``n_layers`` independent shuffles of
the same Zipf profile — routers of different layers specialize on
different experts), which is what makes per-layer EPLB maps matter: a
single layer's map cannot balance the other layers' hot experts.

The same per-layer counts drive BOTH deployment modes' pricing: the
colocated path scales each layer's serial MoE term, the ``moe_attn``
path scales that layer's expert-stage time inside the DP-domain
pipeline (where mild imbalance can hide under attention until the
expert pool saturates — the per-pool utilization/bubble metrics make
that visible). All randomness flows from one ``numpy`` Generator —
same seed, same trace.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass
class WorkloadConfig:
    arrival_rate: float = 400.0       # requests/s across the pod
    duration_s: float = 4.0           # arrival window (sim runs to drain)
    short_len: int = 256              # mean short-prompt tokens
    long_len: int = 2048              # mean long-prompt tokens
    long_fraction: float = 0.15
    mean_output: int = 128            # mean generated tokens
    max_output: int = 512
    min_prompt: int = 16
    max_prompt: int = 6144
    # §7.2 long-context traffic: a fraction of prompts drawn around
    # ``long_context_len`` (above the router's dedicated-TE threshold),
    # NOT clipped to max_prompt. 0 leaves the RNG stream untouched so
    # existing seeds reproduce byte-identically.
    long_context_fraction: float = 0.0
    long_context_len: int = 16384
    # multi-turn sessions (the radix prefix-cache traffic): with
    # probability ``prefix_share`` an arrival CONTINUES a live session —
    # its prompt is the previous turn's prompt plus a fresh lognormal
    # extension, so consecutive turns share a growing block prefix.
    # Sessions retire after ``session_max_turns`` turns or at the prompt
    # cap; at most ``max_sessions`` are live. 0 leaves the RNG stream
    # untouched so existing seeds reproduce byte-identically.
    prefix_share: float = 0.0
    session_extend_len: int = 192     # mean tokens appended per turn
    session_max_turns: int = 8
    max_sessions: int = 512
    # session migration (the pod-pooled prefix-KV traffic): with this
    # probability a CONTINUING session turn is tagged ``migrate`` — the
    # router re-lands it away from its warm TE (front-end rebalancing /
    # TE drain / scale-out breaking stickiness), so its prefix lives on
    # a DIFFERENT TE's cache and only the pod directory can serve it.
    # 0 draws nothing extra, so existing seeds reproduce byte-
    # identically.
    session_migration: float = 0.0
    expert_skew: float = 0.0          # Zipf exponent; 0 → uniform experts
    seed: int = 0


class WorkloadGen:
    def __init__(self, cfg: WorkloadConfig, n_experts: int = 0,
                 n_layers: int = 1):
        self.cfg = cfg
        self.n_experts = n_experts
        self.n_layers = max(1, int(n_layers))
        self.rng = np.random.default_rng(cfg.seed)
        # live multi-turn sessions: (prompt_tokens, turns_so_far)
        self._sessions: List[tuple] = []
        self._expert_popularity = self._make_popularity()

    def _make_popularity(self) -> Optional[np.ndarray]:
        """[n_layers, n_experts] routing popularity; per-layer shuffles
        put each layer's hot experts at different indices."""
        if not self.n_experts:
            return None
        if self.cfg.expert_skew <= 0:
            return np.full((self.n_layers, self.n_experts),
                           1.0 / self.n_experts)
        ranks = np.arange(1, self.n_experts + 1, dtype=np.float64)
        base = ranks ** (-self.cfg.expert_skew)
        layers = []
        for _ in range(self.n_layers):
            p = base.copy()
            self.rng.shuffle(p)      # hot experts at random indices
            layers.append(p / p.sum())
        return np.stack(layers)

    # ------------------------------------------------------------------
    def requests(self) -> Iterator[tuple]:
        """Yield ``(arrival_time, Request)`` in arrival order."""
        c = self.cfg
        t = 0.0
        while t < c.duration_s:
            t += float(self.rng.exponential(1.0 / c.arrival_rate))
            if t >= c.duration_s:
                return
            yield t, self._one_request()

    def _one_request(self) -> Request:
        c = self.cfg
        if (c.prefix_share > 0 and self._sessions
                and self.rng.random() < c.prefix_share):
            return self._session_turn()
        if (c.long_context_fraction > 0
                and self.rng.random() < c.long_context_fraction):
            # §7.2 long-context request: clipped only from below — it
            # must stay above the dedicated-TE routing threshold
            plen = int(max(self.rng.lognormal(np.log(c.long_context_len),
                                              0.3), c.min_prompt))
            out = int(np.clip(
                self.rng.lognormal(np.log(c.mean_output), 0.6), 4,
                c.max_output))
            toks = self.rng.integers(2, 60, plen).tolist()
            return Request(prompt_tokens=toks, max_new_tokens=out,
                           ignore_eos=True, temperature=0.0)
        if self.rng.random() < c.long_fraction:
            mean = c.long_len
        else:
            mean = c.short_len
        plen = int(np.clip(self.rng.lognormal(np.log(mean), 0.5),
                           c.min_prompt, c.max_prompt))
        out = int(np.clip(self.rng.lognormal(np.log(c.mean_output), 0.6),
                          4, c.max_output))
        toks = self.rng.integers(2, 60, plen).tolist()
        if c.prefix_share > 0 and len(self._sessions) < c.max_sessions:
            self._sessions.append((toks, 1))   # opens a session
        return Request(prompt_tokens=toks, max_new_tokens=out,
                       ignore_eos=True, temperature=0.0)

    def _session_turn(self) -> Request:
        """Continue a live session: previous prompt + fresh extension
        (the new user turn), so the old prompt is an exact block prefix
        of the new one — exactly what the radix cache exploits."""
        c = self.cfg
        i = int(self.rng.integers(len(self._sessions)))
        prev, turns = self._sessions[i]
        ext = int(np.clip(self.rng.lognormal(np.log(c.session_extend_len),
                                             0.4), 8, c.max_prompt))
        toks = list(prev) + self.rng.integers(2, 60, ext).tolist()
        if len(toks) > c.max_prompt:
            toks = toks[:c.max_prompt]     # head-clip keeps the prefix
        out = int(np.clip(self.rng.lognormal(np.log(c.mean_output), 0.6),
                          4, c.max_output))
        if turns + 1 >= c.session_max_turns or len(toks) >= c.max_prompt:
            self._sessions.pop(i)          # session retires
        else:
            self._sessions[i] = (toks, turns + 1)
        req = Request(prompt_tokens=toks, max_new_tokens=out,
                      ignore_eos=True, temperature=0.0)
        if (c.session_migration > 0
                and self.rng.random() < c.session_migration):
            req.migrate = True
        return req

    # ------------------------------------------------------------------
    def expert_counts(self, n_tokens: int, top_k: int) -> np.ndarray:
        """Routed token counts [n_layers, n_experts] for one decode
        iteration (each simulated MoE layer routes independently)."""
        if self._expert_popularity is None:
            return np.zeros((self.n_layers, 0), np.int64)
        draws = n_tokens * top_k
        return np.stack([self.rng.multinomial(draws, p)
                         for p in self._expert_popularity])\
            .astype(np.int64)

    def set_skew(self, skew: float) -> None:
        """Flip expert popularity mid-run (scenario: traffic shift)."""
        self.cfg = dataclasses.replace(self.cfg, expert_skew=skew)
        self._expert_popularity = self._make_popularity()
