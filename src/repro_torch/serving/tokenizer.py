"""Byte-level tokenizer (self-contained; no external vocab files).

Token ids: 0 = PAD, 1 = EOS/BOS sentinel, 2..257 = bytes. IDs are folded
into the model vocab by construction (every assigned arch has vocab ≥
49152 ≫ 258). Detokenization runs in each DP's output child process
(output shortcutting, §4.2).
"""
from __future__ import annotations

from typing import List

PAD, EOS = 0, 1
_OFFSET = 2


class ByteTokenizer:
    vocab_size = 258

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b + _OFFSET for b in text.encode("utf-8")]
        return ([EOS] + ids) if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(i - _OFFSET for i in ids
                     if i >= _OFFSET and i - _OFFSET < 256)
        return data.decode("utf-8", errors="replace")
