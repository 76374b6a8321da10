"""Character-level tokenizer with SentencePiece ``.vocab`` file semantics.

Own copy of ``multimodal_av_model_tpu/text/tokenizer.py:31-90``
(``CharTokenizer``): one ``token<TAB>logprob`` line per id, per-character
encode with ``' '`` -> ``'▁'``, decode that drops out-of-range ids.  On the
shipped ``assets/tokenizer800.vocab`` the special ids are ``unk=0, <s>=1,
</s>=2, blank=3, ▁=4``.
"""

from __future__ import annotations

from typing import Iterable

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
