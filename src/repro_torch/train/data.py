"""Data pipeline: a deterministic synthetic corpus, packed into fixed-length
sequences — the reference's ``train/data.py`` (numpy only), with the
port's own byte tokenizer: its batches are token for token the
reference's for the same ``DataConfig``.

A reproducible byte-level corpus with enough structure that a small
model visibly learns (repeated templates, a Zipfian vocabulary, copy
spans), packed into [batch, seq_len] with EOS separators and a loss
mask that excludes padding.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.serving.tokenizer import EOS, PAD, ByteTokenizer

_WORDS = [
    "the", "model", "serves", "tokens", "expert", "attention", "cache",
    "pod", "fabric", "memory", "dispatch", "combine", "latency", "batch",
    "decode", "prefill", "router", "load", "balance", "stream", "kernel",
    "schedule", "transfer", "quantize", "scale", "matrix", "vector",
]


@dataclasses.dataclass
class DataConfig:
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 0
    zipf_a: float = 1.3
    copy_prob: float = 0.2


class SyntheticCorpus:
    """Deterministic document stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.tok = ByteTokenizer()

    def documents(self) -> Iterator[List[int]]:
        while True:
            n_words = int(self.rng.integers(8, 40))
            ranks = self.rng.zipf(self.cfg.zipf_a, size=n_words)
            words = [_WORDS[(r - 1) % len(_WORDS)] for r in ranks]
            if self.rng.random() < self.cfg.copy_prob and n_words > 6:
                # copy-span structure: "A B C | A B C" teaches induction
                half = words[: n_words // 2]
                words = half + ["|"] + half
            text = " ".join(words) + "."
            yield self.tok.encode(text, add_bos=False)


class PackedLoader:
    """Packs documents into [batch, seq_len] with EOS separators and a
    loss mask that excludes padding."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.docs = SyntheticCorpus(cfg).documents()
        self._buf: List[int] = []

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (tokens [B,S], labels [B,S], mask [B,S])."""
        B, S = self.cfg.global_batch, self.cfg.seq_len
        need = B * (S + 1)
        while len(self._buf) < need:
            self._buf.extend(next(self.docs) + [EOS])
        flat = np.asarray(self._buf[:need], np.int32)
        self._buf = self._buf[need:]
        seqs = flat.reshape(B, S + 1)
        tokens, labels = seqs[:, :-1], seqs[:, 1:]
        mask = (labels != PAD).astype(np.float32)
        return tokens, np.ascontiguousarray(labels), mask

    def __iter__(self):
        while True:
            yield self.next_batch()
