"""Korean text: the legacy family's syllable vocabulary and jamo-level
error counts.

Own copy of ``multimodal_av_model_tpu/text/korean.py:17-92``:

* ``KoreanSyllableVocab`` (``:17-33``): ``<blank>`` at id 0 and the 11,172
  Hangul syllables U+AC00-U+D7A3, 11,173 ids in all; text -> ids drops
  characters outside the block;
* jamo counts and ``jamo_error_rate`` (``:74-92``): each Hangul syllable
  decomposes into its choseong, jungseong and (if any) jongseong, so a wrong
  vowel costs a third of a syllable rather than a whole character;
* ``is_hangul_syllable`` (``:36-37``).
"""

from __future__ import annotations

from typing import Iterable

from ..ops.metrics import corpus_counts, rate_from_counts

_HANGUL_START = 0xAC00
_HANGUL_END = 0xD7A3  # inclusive


class KoreanSyllableVocab:
    """The legacy family's vocabulary: ``<blank>`` (0) + every Hangul syllable."""

    blank_id = 0

    def __init__(self) -> None:
        self.vocab = ["<blank>"] + [chr(c) for c in range(_HANGUL_START, _HANGUL_END + 1)]
        self._char2idx = {ch: i for i, ch in enumerate(self.vocab)}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def text_to_indices(self, text: str) -> list[int]:
        return [self._char2idx[ch] for ch in text if ch in self._char2idx]

    def indices_to_text(self, indices: Iterable[int]) -> str:
        return "".join(self.vocab[i] for i in indices if i != 0)

_N_JUNG, _N_JONG = 21, 28

_CHOSEONG = ["ㄱ", "ㄲ", "ㄴ", "ㄷ", "ㄸ", "ㄹ", "ㅁ", "ㅂ", "ㅃ", "ㅅ",
             "ㅆ", "ㅇ", "ㅈ", "ㅉ", "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ"]
_JUNGSEONG = ["ㅏ", "ㅐ", "ㅑ", "ㅒ", "ㅓ", "ㅔ", "ㅕ", "ㅖ", "ㅗ", "ㅘ",
              "ㅙ", "ㅚ", "ㅛ", "ㅜ", "ㅝ", "ㅞ", "ㅟ", "ㅠ", "ㅡ", "ㅢ", "ㅣ"]
_JONGSEONG = ["", "ㄱ", "ㄲ", "ㄳ", "ㄴ", "ㄵ", "ㄶ", "ㄷ", "ㄹ", "ㄺ",
              "ㄻ", "ㄼ", "ㄽ", "ㄾ", "ㄿ", "ㅀ", "ㅁ", "ㅂ", "ㅄ", "ㅅ",
              "ㅆ", "ㅇ", "ㅈ", "ㅊ", "ㅋ", "ㅌ", "ㅍ", "ㅎ"]


def is_hangul_syllable(ch: str) -> bool:
    """True for a character of the Hangul syllable block U+AC00-U+D7A3."""
    return _HANGUL_START <= ord(ch) <= _HANGUL_END


def syllable_to_jamo(ch: str) -> list[str]:
    """One Hangul syllable -> its jamo; other characters pass through."""
    if not is_hangul_syllable(ch):
        return [ch]
    cho, rem = divmod(ord(ch) - _HANGUL_START, _N_JUNG * _N_JONG)
    jung, jong = divmod(rem, _N_JONG)
    out = [_CHOSEONG[cho], _JUNGSEONG[jung]]
    if jong:
        out.append(_JONGSEONG[jong])
    return out


def text_to_jamo(text: str) -> list[str]:
    return [j for ch in text for j in syllable_to_jamo(ch)]


def jamo_counts(references, hypotheses) -> tuple[int, int]:
    """(edit distance, reference length) at the jamo level, whitespace runs
    collapsed to one space."""
    if isinstance(references, str):
        references, hypotheses = [references], [hypotheses]
    return corpus_counts([text_to_jamo(" ".join(r.split())) for r in references],
                         [text_to_jamo(" ".join(h.split())) for h in hypotheses])


def jamo_error_rate(references, hypotheses) -> float:
    """The corpus error rate at the jamo level (``korean.py:74-79``)."""
    return rate_from_counts(*jamo_counts(references, hypotheses))
