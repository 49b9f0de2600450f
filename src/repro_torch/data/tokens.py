"""Synthetic token pipeline for the LM-scale architectures: deterministic
per-shard streams with a Zipfian unigram mixture + local n-gram structure
so losses actually decrease during smoke training."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, vocab + 1), a)
    return w / w.sum()


class TokenStream:
    """Infinite deterministic stream of (tokens, labels) batches."""

    def __init__(self, cfg: TokenStreamConfig, shard: int = 0,
                 num_shards: int = 1):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed * 9973 + shard)
        self.probs = _zipf_probs(min(cfg.vocab_size, 50_000), cfg.zipf_a)
        self.vocab_eff = self.probs.shape[0]

    def next_batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        base = self.rng.choice(self.vocab_eff, (c.batch_size, c.seq_len + 1),
                               p=self.probs)
        # inject copy structure: second half repeats the first half shifted
        half = (c.seq_len + 1) // 2
        base[:, half:2 * half] = base[:, :half]
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
