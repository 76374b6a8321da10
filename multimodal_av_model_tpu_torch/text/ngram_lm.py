"""Character bigram language model for shallow fusion.

Own copy of ``multimodal_av_model_tpu/text/ngram_lm.py:23-93`` (numpy only).
A smoothed bigram over token-id sequences, exported as a dense ``[V+1, V]``
log-probability table: row ``v`` is the distribution of the next token after
token ``v``, the last row the BOS context.  The prefix beam
(``ops/prefix_beam_search.py``) reads it with one gather per candidate.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def train_bigram_lm(sequences: Iterable[Sequence[int]], vocab_size: int,
                    add_k: float = 0.5) -> np.ndarray:
    """Add-k smoothed bigram log-probabilities ``[V+1, V]`` f32 (row ``V`` is
    BOS; every row sums to 1).  Ids outside ``[0, V)`` are skipped."""
    V = vocab_size
    counts = np.zeros((V + 1, V), np.float64)
    for seq in sequences:
        prev = V                               # BOS
        for t in seq:
            t = int(t)
            if not 0 <= t < V:
                continue
            counts[prev, t] += 1.0
            prev = t
    probs = (counts + add_k) / (counts.sum(axis=1, keepdims=True) + add_k * V)
    return np.log(probs).astype(np.float32)


def save_bigram_lm(path: str, lm: np.ndarray) -> None:
    np.save(path, lm)


def load_bigram_lm(path: str) -> np.ndarray:
    lm = np.load(path)
    if lm.ndim != 2 or lm.shape[0] != lm.shape[1] + 1:
        raise ValueError(f"not a bigram LM table: shape {lm.shape}")
    return lm.astype(np.float32)


def mean_token_logprob(lm: np.ndarray, sequences: Iterable[Sequence[int]]) -> float:
    """Mean per-token log-probability of a corpus under the bigram; the
    length bonus that zero-means the LM term is ``-lm_weight`` times it."""
    V = lm.shape[1]
    total, n = 0.0, 0
    for seq in sequences:
        prev = V
        for t in seq:
            t = int(t)
            if not 0 <= t < V:
                continue
            total += float(lm[prev, t])
            prev = t
            n += 1
    return total / max(n, 1)


def sequence_logprob(lm: np.ndarray, seq: Sequence[int]) -> float:
    """Log-probability of a token sequence under the bigram (BOS context)."""
    V = lm.shape[1]
    prev, total = V, 0.0
    for t in seq:
        total += float(lm[prev, int(t)])
        prev = int(t)
    return total
