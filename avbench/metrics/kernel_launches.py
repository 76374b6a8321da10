"""Kernel launches a unit: the CUDA launch calls (`cuda*` and `cu*` APIs)
(``avbench/program.py:LAUNCHES``) in the profiled stretch, over its units."""

from ._program import program


def read(records: dict, kind: str | None):
    prog = program(records, kind)
    if not prog or not prog["profiled_units"] or not prog["launches"]:
        return None
    return prog["launches"] / prog["profiled_units"]
