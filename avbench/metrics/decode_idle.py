"""The device's idle share within the program's ``transcribe.decode`` spans
(infer.py: ``decode_ids``, the prefix-beam loop): their ranges minus the
union of the device operations within them, over their ranges, in the
profiled stretch, in %."""

from ._program import program


def read(records: dict, kind: str | None):
    prog = program(records, kind)
    row = prog["spans"].get("transcribe.decode") if prog else None
    if not row or row["ms"] <= 0:
        return None
    return 100.0 * row["idle_ms"] / row["ms"]
