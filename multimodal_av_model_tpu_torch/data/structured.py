"""Structured synthetic pairs: a learnable audio/visual <-> label correspondence.

Own copy of ``multimodal_av_model_tpu/data/structured.py`` (numpy only; the
draws come in JAX's order, so the pairs are equal byte for byte on the same
seed).  ``SyntheticPairSource`` gives noise, which nothing can learn from;
these sources give the research loops (the AV ablation, pretraining probes)
something to learn:

* ``StructuredPairSource``: each label token is a pure tone (token id ->
  frequency) and each lip frame a sinusoidal grating whose spatial frequency
  encodes the token; ``markov=True`` draws labels from a fixed sparse bigram
  chain;
* ``RealTextStructuredSource``: labels are real sentences (``sentences``,
  for example ``load_reference_sentences`` of an AI-Hub metadata folder),
  each character a two-tone chord and the sum of the two gratings.

Mixing and masks are the production ``mix_pair`` (0/1/2/3 semantics).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from .mixing import mix_pair


class StructuredPairSource:
    """Deterministic-per-seed generator of learnable two-speaker pairs
    (``structured.py:28-122``).  ``load_pair`` gives the host collate layout:
    ``audio``, ``mask1``, ``mask2``, ``lip{n}`` ``[T, 1, H, W]`` f32 in 0..1
    (preprocessed lips), ``label{n}``, ``lip{n}_len``."""

    def __init__(self, tokenizer, seed: int = 0, n_tokens: int = 12,
                 label_len: tuple[int, int] = (3, 7), frames_per_token: int = 4,
                 fps: int = 30, sample_rate: int = 16000, lip_size: int = 96,
                 samples_per_frame: int = 534, markov: bool = False, markov_seed: int = 1234):
        """``markov=True`` draws label sequences from a fixed sparse bigram
        chain (each token has 3 likely successors), fixed by ``markov_seed``
        independently of ``seed``, so train and held-out sources share one
        "language"."""
        self.tokenizer = tokenizer
        self.rng = np.random.default_rng(seed)
        self.token_ids = np.arange(5, 5 + n_tokens)       # past the specials (0-4)
        self.transition = None
        if markov:
            chain_rng = np.random.default_rng(markov_seed)
            trans = np.full((n_tokens, n_tokens), 0.1 / n_tokens)
            for i in range(n_tokens):
                succ = chain_rng.choice(n_tokens, size=3, replace=False)
                trans[i, succ] += 0.9 / 3
            self.transition = trans / trans.sum(axis=1, keepdims=True)
        self.label_len = label_len
        self.frames_per_token = frames_per_token
        self.fps = fps
        self.sample_rate = sample_rate
        self.lip_size = lip_size
        self.samples_per_frame = samples_per_frame

    def _tone(self, token_idx: int, n: int, phase: float) -> np.ndarray:
        freq = 300.0 + 120.0 * token_idx                   # well apart under the 80-mel bank
        t = np.arange(n) / self.sample_rate
        return np.sin(2 * np.pi * freq * t + phase).astype(np.float32)

    def _grating(self, token_idx: int) -> np.ndarray:
        """Lip frame stand-in: a horizontal grating, spatial frequency = token."""
        x = np.linspace(0, 2 * np.pi, self.lip_size, dtype=np.float32)
        return 0.5 + 0.5 * np.sin((token_idx + 2) * x)[None, :] * np.ones(
            (self.lip_size, 1), np.float32)

    def one_utterance(self):
        L = int(self.rng.integers(*self.label_len))
        if self.transition is None:
            tok_idx = self.rng.integers(0, len(self.token_ids), size=L)
        else:
            n = len(self.token_ids)
            tok_idx = np.empty(L, np.int64)
            tok_idx[0] = self.rng.integers(0, n)
            for j in range(1, L):
                tok_idx[j] = self.rng.choice(n, p=self.transition[tok_idx[j - 1]])
        label = self.token_ids[tok_idx].astype(np.int64)

        spf = self.samples_per_frame * self.frames_per_token
        audio = np.concatenate([
            self._tone(int(i), spf, phase=float(self.rng.uniform(0, 2 * np.pi)))
            for i in tok_idx])
        audio += (self.rng.standard_normal(audio.shape) * 0.02).astype(np.float32)

        lip = np.stack([self._grating(int(i)) for i in tok_idx
                        for _ in range(self.frames_per_token)])[:, None, :, :]   # [T, 1, H, W]
        lip += self.rng.standard_normal(lip.shape).astype(np.float32) * 0.02
        return audio.astype(np.float32), lip.astype(np.float32), label

    def load_pair(self, *_args) -> dict:
        a1, lip1, label1 = self.one_utterance()
        a2, lip2, label2 = self.one_utterance()
        mixed, mask1, mask2 = mix_pair(a1, a2)
        return {"audio": mixed, "mask1": mask1, "mask2": mask2,
                "lip1": lip1, "label1": label1, "lip1_len": lip1.shape[0],
                "lip2": lip2, "label2": label2, "lip2_len": lip2.shape[0]}


def load_reference_sentences(json_folder: str) -> list[str]:
    """Every non-empty ``Sentence_info[].sentence_text`` of the AI-Hub
    metadata JSONs in ``json_folder``, in file-name order
    (``structured.py:125-144``).  The folder is the caller's: nothing
    defaults to one."""
    sents: list[str] = []
    for path in sorted(glob.glob(os.path.join(json_folder, "*.json"))):
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if isinstance(doc, list):
            doc = doc[0] if doc else {}
        for s in doc.get("Sentence_info", []):
            text = s.get("sentence_text", "").strip()
            if text:
                sents.append(text)
    return sents


class RealTextStructuredSource(StructuredPairSource):
    """Structured pairs whose labels are real transcripts
    (``structured.py:147-234``): a random sentence, cropped to ``max_chars``
    (or, with ``min_chars``, to a length drawn from ``[min_chars,
    max_chars]``, so paired utterances differ in length and the masks keep
    solo frames), each character rendered as a two-tone chord (token id -> a
    pair of ``n_base`` log-spaced base frequencies, 250..7500 Hz) over
    ``frames_per_token`` frames, and its lip frames as the two matching
    gratings superimposed."""

    def __init__(self, tokenizer, sentences: list[str], seed: int = 0, max_chars: int = 12,
                 min_chars: int | None = None, n_base: int = 42, **kw):
        kw.setdefault("frames_per_token", 4)
        super().__init__(tokenizer, seed=seed, **kw)
        if not sentences:
            raise ValueError("need at least one sentence")
        self.sentences = list(sentences)
        self.max_chars = max_chars
        self.min_chars = min_chars
        self.n_base = n_base
        pairs = [(i, j) for i in range(n_base) for j in range(i + 1, n_base)]
        if tokenizer.vocab_size > len(pairs):
            raise ValueError(f"n_base={n_base} gives {len(pairs)} chords < vocab "
                             f"{tokenizer.vocab_size}")
        self._chord = {tid: pairs[tid] for tid in range(tokenizer.vocab_size)}
        self._freqs = 250.0 * (7500.0 / 250.0) ** (np.arange(n_base) / max(n_base - 1, 1))

    def _chord_tone(self, token_id: int, n: int, phase: float) -> np.ndarray:
        i, j = self._chord[int(token_id)]
        t = np.arange(n) / self.sample_rate
        return (0.5 * np.sin(2 * np.pi * self._freqs[i] * t + phase)
                + 0.5 * np.sin(2 * np.pi * self._freqs[j] * t + 1.7 * phase)).astype(np.float32)

    def _chord_grating(self, token_id: int) -> np.ndarray:
        i, j = self._chord[int(token_id)]
        x = np.linspace(0, 2 * np.pi, self.lip_size, dtype=np.float32)
        img = (0.5 + 0.25 * np.sin((i % 20 + 2) * x)[None, :]
               + 0.25 * np.sin((j % 20 + 2) * x)[:, None])
        return img.astype(np.float32) * np.ones((self.lip_size, self.lip_size), np.float32)

    def one_utterance(self):
        sent = self.sentences[int(self.rng.integers(len(self.sentences)))]
        limit = (self.max_chars if self.min_chars is None else
                 int(self.rng.integers(self.min_chars, self.max_chars + 1)))
        if len(sent) > limit:
            start = int(self.rng.integers(0, len(sent) - limit + 1))
            sent = sent[start:start + limit]
        label = np.asarray(self.tokenizer.encode(sent), np.int64)
        if label.size == 0:
            label = np.asarray(self.tokenizer.encode(" "), np.int64)

        spf = self.samples_per_frame * self.frames_per_token
        audio = np.concatenate([
            self._chord_tone(int(tid), spf, phase=float(self.rng.uniform(0, 2 * np.pi)))
            for tid in label])
        audio += (self.rng.standard_normal(audio.shape) * 0.02).astype(np.float32)

        lip = np.stack([self._chord_grating(int(tid)) for tid in label
                        for _ in range(self.frames_per_token)])[:, None, :, :]
        lip += self.rng.standard_normal(lip.shape).astype(np.float32) * 0.02
        return audio.astype(np.float32), lip.astype(np.float32), label
