"""Preprocessing (data/device_pipeline.py: H2D of the raw batch, mixing, K2 on
both speakers): host clock around the call, synchronised before and after, ms
per step or request."""

from ._spans import per_unit_ms


def read(records: dict, kind: str | None):
    return per_unit_ms(records, "preprocess", kind)
