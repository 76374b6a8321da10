"""Numerical guard of the train loop.

Own copy of ``multimodal_av_model_tpu/train/profiling.py:53-67``: the loop
raises on a non-finite metric instead of training on silently.
"""

from __future__ import annotations

import math
from typing import Mapping


class NonFiniteLossError(RuntimeError):
    pass


def check_finite(metrics: Mapping[str, object], step: int | None = None) -> None:
    """Raise with the offending keys if any metric is NaN or infinite."""
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    if bad:
        at = f" at step {step}" if step is not None else ""
        raise NonFiniteLossError(f"non-finite metrics{at}: {bad}")
