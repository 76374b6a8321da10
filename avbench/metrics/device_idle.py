"""The device's idle share of the profiled stretch: 1 - (union of the device
operations' intervals) / (host clock over the stretch), in %."""


def read(records: dict, kind: str | None):
    tr = records.get("trace")
    if kind != records["kind"] or not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
