"""Shared by the span readers: the mean of a span's seconds per unit, in ms."""


def per_unit_ms(records: dict, span: str, kind: str | None):
    """Mean milliseconds of ``span`` per unit of the traced window, or None
    where the run is of another kind or recorded no such span."""
    values = records["spans"].get(span)
    if kind != records["kind"] or not values or not records["units"]:
        return None
    return 1e3 * sum(values) / records["units"]
