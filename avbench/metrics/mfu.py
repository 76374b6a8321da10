"""The whole step's (or request's) share of the card's dense bf16 peak: the
model's operations counted from the configuration and shapes (avbench/flops.py)
times the units of the traced window, over its seconds and 989 TFLOP/s, in %."""

from ..roofline import PEAK_BF16_FLOPS


def read(records: dict, kind: str | None):
    if kind != records["kind"] or not records["units"] or records["window_s"] <= 0:
        return None
    done = records["flops_per_unit"] * records["units"]
    return 100.0 * done / records["window_s"] / PEAK_BF16_FLOPS
