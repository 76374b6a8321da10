"""Epoch logs and throughput accounting of the train loop.

Own copy of ``multimodal_av_model_tpu/train/logging_utils.py:18-101``:
``CsvLogger`` (header written once; ``resume`` appends to an existing file),
``TensorBoardLogger`` (per-epoch scalars through ``tensorboardX`` when it is
importable, else a no-op) and ``StepTimer``.  The port's ``StepTimer`` also
keeps ``input_waits``: the seconds the step loop spent getting each batch,
reported as their sum and the first batch's share (a new epoch's prefetch
worker makes the loop wait for its whole first batch; the rest shows whether
loading keeps up with the steps).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any


class CsvLogger:
    def __init__(self, path: str, fieldnames: list[str], resume: bool = False):
        self.path = path
        self.fieldnames = fieldnames
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        mode = "a" if (resume and os.path.exists(path)) else "w"
        self._f = open(path, mode, newline="")
        self._w = csv.DictWriter(self._f, fieldnames=fieldnames)
        if mode == "w":
            self._w.writeheader()
            self._f.flush()

    def log(self, **row: Any) -> None:
        self._w.writerow({k: row.get(k, "") for k in self.fieldnames})
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TensorBoardLogger:
    """Scalars to ``log_dir`` when it is set and ``tensorboardX`` imports."""

    def __init__(self, log_dir: str):
        self._w = None
        if not log_dir:
            return
        try:
            from tensorboardX import SummaryWriter

            self._w = SummaryWriter(log_dir)
        except ImportError:
            pass

    @property
    def active(self) -> bool:
        return self._w is not None

    def scalars(self, step: int, **values: float) -> None:
        if self._w is None:
            return
        for k, v in values.items():
            try:
                self._w.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


class StepTimer:
    """Utterances per second and the real-time factor since ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.steps = 0
        self.utterances = 0
        self.audio_seconds = 0.0
        self.input_waits: list[float] = []

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
            "elapsed_s": el,
            "input_wait_s": sum(self.input_waits),
            "first_input_wait_s": self.input_waits[0] if self.input_waits else 0.0,
        }
