"""The fusion (models/fusion.py, models/layers.py: compaction, cross-attention,
the BiLSTM loop or the transformer): device-stream time between CUDA events
from forward hooks, ms per request."""

from ._spans import per_unit_ms


def read(records: dict, kind: str | None):
    return per_unit_ms(records, "fusion", kind)
