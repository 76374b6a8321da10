"""The encoders (models/visual.py, models/audio.py with K1): device-stream time
between CUDA events from forward pre- and post-hooks on both encoders, ms per
request."""

from ._spans import per_unit_ms


def read(records: dict, kind: str | None):
    return per_unit_ms(records, "encoders", kind)
