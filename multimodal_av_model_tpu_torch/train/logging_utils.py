"""Throughput accounting of the train loop.

Own copy of ``multimodal_av_model_tpu/train/logging_utils.py:73-101``
(``StepTimer``); the CSV and TensorBoard loggers belong to ``fit``, which is
not ported yet.
"""

from __future__ import annotations

import time


class StepTimer:
    """Utterances per second and the real-time factor since ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.steps = 0
        self.utterances = 0
        self.audio_seconds = 0.0

    def tick(self, batch_size: int, audio_seconds: float = 0.0):
        self.steps += 1
        self.utterances += batch_size
        self.audio_seconds += audio_seconds

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def summary(self) -> dict[str, float]:
        el = max(self.elapsed, 1e-9)
        return {
            "steps_per_sec": self.steps / el,
            "utterances_per_sec": self.utterances / el,
            "rtf": (self.audio_seconds / el) if self.audio_seconds else 0.0,
        }
