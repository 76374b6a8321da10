"""Speaker-distinct sentence pairs for two-speaker mixing.

Own copy of ``multimodal_av_model_tpu/data/pairs.py:21-97``:

* ``generate_fixed_pairs``: a seeded list of index pairs (``random.Random``);
* ``RandomPairSampler``: an epoch of ``num_pairs_per_epoch`` draws, each
  drawing two sentences until their speakers differ, and retrying on a load
  failure, at most ``max_retries`` times;
* ``FixedPairSampler``: the fixed eval pairs, moving on to the next pair
  when one is a single speaker or fails to load.
"""

from __future__ import annotations

import random
from typing import Callable, Sequence

from .manifest import speaker_id_of


def generate_fixed_pairs(sentence_list: Sequence, n_pairs: int = 500, seed: int | None = None):
    rng = random.Random(seed) if seed is not None else random
    indices = list(range(len(sentence_list)))
    pairs = []
    for _ in range(n_pairs):
        i, j = rng.sample(indices, 2)
        pairs.append((sentence_list[i], sentence_list[j]))
    return pairs


class RandomPairSampler:
    """Draws speaker-distinct pairs; ``load_fn(s1, s2)`` builds the sample."""

    def __init__(self, sentence_list: Sequence, load_fn: Callable,
                 num_pairs_per_epoch: int = 10000, max_retries: int = 10, seed: int = 42):
        if len(sentence_list) < 2:
            raise ValueError("need at least two sentences to form pairs")
        self.sentence_list = list(sentence_list)
        self.load_fn = load_fn
        self.num_pairs_per_epoch = num_pairs_per_epoch
        self.max_retries = max_retries
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return self.num_pairs_per_epoch

    def sample(self):
        last_err: Exception | None = None
        for _ in range(self.max_retries):
            s1, s2 = self._rng.sample(self.sentence_list, 2)
            if speaker_id_of(s1["text_path"]) == speaker_id_of(s2["text_path"]):
                continue
            try:
                return self.load_fn(s1, s2)
            except Exception as e:              # a load failure draws again
                last_err = e
        raise RuntimeError(f"pair sampling exhausted {self.max_retries} retries") from last_err

    def __iter__(self):
        for _ in range(self.num_pairs_per_epoch):
            yield self.sample()


class FixedPairSampler:
    """The fixed eval pairs; a failure moves on to the next index."""

    def __init__(self, pair_list: Sequence[tuple], load_fn: Callable, max_retries: int = 10):
        self.pair_list = list(pair_list)
        self.load_fn = load_fn
        self.max_retries = max_retries

    def __len__(self) -> int:
        return len(self.pair_list)

    def get(self, idx: int):
        last_err: Exception | None = None
        for _ in range(self.max_retries):
            s1, s2 = self.pair_list[idx]
            if speaker_id_of(s1["text_path"]) == speaker_id_of(s2["text_path"]):
                idx = (idx + 1) % len(self.pair_list)
                continue
            try:
                return self.load_fn(s1, s2)
            except Exception as e:
                last_err = e
                idx = (idx + 1) % len(self.pair_list)
        raise RuntimeError(
            f"fixed pair loading exhausted {self.max_retries} retries") from last_err

    def __iter__(self):
        for i in range(len(self.pair_list)):
            yield self.get(i)
