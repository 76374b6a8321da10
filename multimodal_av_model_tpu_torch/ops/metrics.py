"""Word and character error-rate counts, in pure Python.

Own copy of ``multimodal_av_model_tpu/ops/metrics.py:16-100``
(``levenshtein_py``, ``levenshtein`` on the native host ops, the additive
corpus counts, ``rate_from_counts`` and the ``wer`` / ``cer`` rates).  A corpus rate is the total edit
distance over the total reference length, so counts from several batches
sum before the division.
"""

from __future__ import annotations

from typing import Sequence


def levenshtein_py(a: Sequence, b: Sequence) -> int:
    """Edit distance (O(len(a) * len(b)), two rows)."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance by the native kernel (``runtime/hostops.cpp``), the
    tokens mapped to int codes first; ``levenshtein_py`` where it did not
    build (``metrics.py:30-43``)."""
    from ..runtime import native

    if not native.have_native():
        return levenshtein_py(a, b)
    codes: dict = {}
    enc = [codes.setdefault(t, len(codes)) for t in a]
    enc_b = [codes.setdefault(t, len(codes)) for t in b]
    return native.levenshtein(enc, enc_b)


def corpus_counts(ref_seqs: list, hyp_seqs: list) -> tuple[int, int]:
    """(total edit distance, total reference length)."""
    return (sum(levenshtein(r, h) for r, h in zip(ref_seqs, hyp_seqs)),
            sum(len(r) for r in ref_seqs))


def rate_from_counts(total_dist: float, total_len: float) -> float:
    if total_len == 0:
        return 0.0 if total_dist == 0 else float("inf")
    return total_dist / total_len


def wer_counts(references: Sequence[str], hypotheses: Sequence[str]) -> tuple[int, int]:
    """Word-level counts over whitespace-split words."""
    return corpus_counts([r.split() for r in references], [h.split() for h in hypotheses])


def cer_counts(references: Sequence[str], hypotheses: Sequence[str],
               remove_spaces: bool = False) -> tuple[int, int]:
    """Character-level counts; whitespace runs collapse to one space."""
    def norm(s: str) -> str:
        s = " ".join(s.split())
        return s.replace(" ", "") if remove_spaces else s

    return corpus_counts([list(norm(r)) for r in references],
                         [list(norm(h)) for h in hypotheses])


def _as_lists(references, hypotheses):
    """One ``str`` each -> one-element lists (``metrics.py:81-82``)."""
    if isinstance(references, str):
        return [references], [hypotheses]
    return references, hypotheses


def wer(references: Sequence[str] | str, hypotheses: Sequence[str] | str) -> float:
    """Corpus word error rate over whitespace-split words (``metrics.py:79-83``)."""
    return rate_from_counts(*wer_counts(*_as_lists(references, hypotheses)))


def cer(references: Sequence[str] | str, hypotheses: Sequence[str] | str,
        remove_spaces: bool = False) -> float:
    """Corpus character error rate, whitespace runs collapsed to one space
    (``metrics.py:86-100``)."""
    return rate_from_counts(*cer_counts(*_as_lists(references, hypotheses), remove_spaces))
