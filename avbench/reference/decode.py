"""CTC prefix beam search in float64, one utterance at a time, and ids to text.

Beams are collapsed label prefixes with two log-masses, ``pb`` (alignments
ending in blank) and ``pnb`` (ending in the prefix's last label).  Per frame
each beam proposes one candidate that stays (``pb' = (pb + pnb) P(blank)``,
``pnb' = pnb P(last)``) and one per token of the frame's top ``K`` (lower id
first on equal scores): the blank proposes nothing, the prefix's last label
extends from ``pb`` alone, any other label from ``pb + pnb``.  Candidates
with equal prefixes merge into the first by log-sum-exp, and the ``W`` best
by total mass survive (the earlier candidate first on equal mass).  The
search starts from the empty prefix alone; frames past the utterance's
length are skipped.  The best beam's prefix is the answer.
"""

from __future__ import annotations

import numpy as np

NEG = -np.inf


def _lse(a: float, b: float) -> float:
    return float(np.logaddexp(a, b))


def prefix_beam(lp: np.ndarray, length: int, beam: int, top_k: int, blank: int) -> list[int]:
    """``lp [T, V]`` log-probabilities -> the best prefix's ids."""
    lp = np.asarray(lp, np.float64)
    beams = [((), 0.0, NEG)]                       # (prefix, pb, pnb)
    K = min(top_k, lp.shape[1])
    for t in range(min(length, lp.shape[0])):
        row = lp[t]
        top = np.argsort(-row, kind="stable")[:K]
        cands: dict[tuple, list[float]] = {}
        order: list[tuple] = []

        def add(prefix, pb, pnb):
            if prefix not in cands:
                cands[prefix] = [NEG, NEG]
                order.append(prefix)
            c = cands[prefix]
            c[0], c[1] = _lse(c[0], pb), _lse(c[1], pnb)

        for prefix, pb, pnb in beams:
            total = _lse(pb, pnb)
            last = prefix[-1] if prefix else None
            add(prefix, total + row[blank], pnb + row[last] if last is not None else NEG)
            for c in top:
                c = int(c)
                if c == blank:
                    continue
                base = pb if c == last else total
                add(prefix + (c,), NEG, base + row[c])
        ranked = sorted(range(len(order)), key=lambda i: -_lse(*cands[order[i]]))
        beams = [(order[i], *cands[order[i]]) for i in ranked[:beam]]
    return list(beams[0][0])


def read_vocab(path: str) -> list[str]:
    """A tab-separated vocabulary file: the token of each line, by line number."""
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n").split("\t")[0] for line in f]


def to_text(vocab: list[str], ids) -> str:
    """Ids -> text: tokens joined, the word marker U+2581 read as a space,
    the ends stripped."""
    return "".join(vocab[i] for i in ids if 0 <= i < len(vocab)).replace("▁", " ").strip()
