"""The program's ``host_syncs`` counter: synchronising CUDA calls (blocking
copies, ``.cpu()``, ``F.ctc_loss``'s length copies), counted by the CUDA sync
debug mode against the innermost span, summed over every span of a unit
(under ``preprocess`` and ``train.step`` or ``transcribe``), per unit of
the window."""

from ._program import counter_per_unit


def read(records: dict, kind: str | None):
    return counter_per_unit(records, kind, "host_syncs")
