"""Character-level tokenizer with SentencePiece ``.vocab`` file semantics.

Own copy of ``multimodal_av_model_tpu/text/tokenizer.py:31-149``
(``CharTokenizer``): one ``token<TAB>logprob`` line per id, per-character
encode with ``' '`` -> ``'▁'``, decode that drops out-of-range ids,
``decode_ctc`` (blanks dropped, no merge) and ``encode_array``;
``Tokenizer`` is its other name (``tokenizer.py:93-94``).  On the
shipped ``assets/tokenizer800.vocab`` the special ids are ``unk=0, <s>=1,
</s>=2, blank=3, ▁=4``.  ``build_char_vocab``, ``write_vocab`` and
``train_tokenizer_from_txt_folder`` build such a vocab from text files, byte
for byte as the JAX package does.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Iterable, Sequence

import numpy as np

_SP_SPACE = "▁"


class CharTokenizer:
    """Loads a tab-separated ``.vocab`` file into token<->id maps."""

    def __init__(self, vocab_path: str):
        self.vocab_path = vocab_path
        self.token_to_id: dict[str, int] = {}
        self.id_to_token: list[str] = []
        with open(vocab_path, "r", encoding="utf-8") as f:
            for idx, line in enumerate(f):
                token = line.rstrip("\n").split("\t")[0]
                self.token_to_id.setdefault(token, idx)
                self.id_to_token.append(token)

    def encode(self, text: str) -> list[int]:
        unk = self.unk_id
        t2i = self.token_to_id
        return [t2i.get(_SP_SPACE if ch == " " else ch, unk) for ch in text]

    def decode(self, ids: Iterable[int]) -> str:
        n = len(self.id_to_token)
        toks = [self.id_to_token[i] for i in ids if 0 <= i < n]
        return "".join(toks).replace(_SP_SPACE, " ").strip()

    def decode_ctc(self, ids: Iterable[int]) -> str:
        """Ids -> text with blanks dropped and no CTC merge
        (``tokenizer.py:56-62``)."""
        blank = self.blank_id
        n = len(self.id_to_token)
        toks = [self.id_to_token[i] for i in ids if i != blank and 0 <= i < n]
        return "".join(toks).replace(_SP_SPACE, " ").strip()

    def encode_array(self, text: str, pad_to: int | None = None) -> np.ndarray:
        """``encode`` as int32, cut or padded with ``pad_id`` to ``pad_to``
        (``tokenizer.py:66-72``)."""
        ids = self.encode(text)
        if pad_to is not None:
            ids = ids[:pad_to] + [self.pad_id] * (pad_to - len(ids[:pad_to]))
        return np.asarray(ids, dtype=np.int32)

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_token)

    @property
    def pad_id(self) -> int:
        return self.token_to_id.get("<pad>", 0)

    @property
    def blank_id(self) -> int:
        return self.token_to_id.get("<blank>", 0)

    @property
    def unk_id(self) -> int:
        return self.token_to_id.get("<unk>", 0)


# The reference's class name (``tokenizer.py:93-94``).
Tokenizer = CharTokenizer


def build_char_vocab(texts: Iterable[str], vocab_size: int = 800,
                     specials: Sequence[str] = ("<unk>", "<s>", "</s>", "<blank>"),
                     ) -> list[tuple[str, float]]:
    """The frequency-sorted character vocab with the SentencePiece-style
    header (``tokenizer.py:97-131``): specials at score 0, then ``'▁'``, then
    characters by falling count (ties by character), each scored by its log
    frequency, up to ``vocab_size`` entries."""
    counts: Counter[str] = Counter()
    for text in texts:
        for ch in text.strip():
            counts[_SP_SPACE if ch == " " else ch] += 1
    total = sum(counts.values()) or 1
    entries: list[tuple[str, float]] = [(s, 0.0) for s in specials]
    seen = set(specials)
    ordered = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    if _SP_SPACE in counts:
        ordered = [(_SP_SPACE, counts[_SP_SPACE])] + [(t, c) for t, c in ordered
                                                     if t != _SP_SPACE]
    for tok, c in ordered:
        if tok in seen:
            continue
        entries.append((tok, float(np.log(c / total))))
        seen.add(tok)
        if len(entries) >= vocab_size:
            break
    return entries


def write_vocab(entries: Sequence[tuple[str, float]], path: str) -> None:
    """One ``token<TAB>score`` line per entry (``tokenizer.py:134-138``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for tok, score in entries:
            f.write(f"{tok}\t{score:g}\n")


def train_tokenizer_from_txt_folder(txt_folder: str, vocab_path: str,
                                    vocab_size: int = 800) -> CharTokenizer:
    """The vocab of every ``*.txt`` under ``txt_folder`` (name order) written
    to ``vocab_path`` and loaded (``tokenizer.py:141-149``)."""
    texts = []
    for name in sorted(os.listdir(txt_folder)):
        if name.endswith(".txt"):
            with open(os.path.join(txt_folder, name), "r", encoding="utf-8") as f:
                texts.append(f.read())
    write_vocab(build_char_vocab(texts, vocab_size=vocab_size), vocab_path)
    return CharTokenizer(vocab_path)
