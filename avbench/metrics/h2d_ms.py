"""The program's ``preprocess.h2d`` spans (data/device_pipeline.py:_on): the
pageable host-to-device copies of a unit's raw inputs (crops, waveforms,
lengths), host clock summed over the copies, ms per step or request of the
window.  The copies block the host, so their host time is the copy's."""

from ._program import window_per_unit


def read(records: dict, kind: str | None):
    return window_per_unit(records, kind, "preprocess.h2d", "host_ms")
