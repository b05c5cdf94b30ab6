"""Synthetic token streams for the LM architecture pool (port of
``repro.data.tokens``, the same numpy draw).

Zipf-distributed token ids (matching natural-language frequency shape)
so that the cooperative-embedding-gather transfer of the paper's idea
(DESIGN.md §4) sees realistic duplicate rates.
"""
from __future__ import annotations

import numpy as np


def synthetic_token_batch(
    batch: int, seq: int, vocab: int, seed: int = 0, zipf_a: float = 1.1
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # rejection-free bounded zipf via inverse-CDF over a truncated support
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    return rng.choice(vocab, size=(batch, seq), p=probs).astype(np.int32)
