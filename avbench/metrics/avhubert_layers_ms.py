"""AV-HuBERT's transformer layers and final LayerNorm (models/avhubert.py:
``AVHubertCTC.encoder``), forward: device-stream time between CUDA events
from forward pre- and post-hooks on the stack, ms per training step."""

from ._spans import per_unit_ms


def read(records: dict, kind: str | None):
    return per_unit_ms(records, "avhubert_layers", kind)
