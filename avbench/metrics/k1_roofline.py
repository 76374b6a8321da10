"""K1, the log-mel kernel (csrc/logmel.cu), against its roofline: the least
time of one launch at the traffic's shapes (its bytes in and out, or its least
FFT-and-mel operations at the f32 peak) over the mean profiled device time of
its launches, in %; None without launches."""

from ..roofline import least_seconds


def read(records: dict, kind: str | None):
    tr = records.get("trace")
    if kind != records["kind"] or not tr:
        return None
    times = tr["kernels"].get("logmel_kernel") or []
    if not times:
        return None
    flops, nbytes = records["kernel_work"]["logmel_kernel"]
    return 100.0 * least_seconds(flops, nbytes) / (sum(times) / len(times))
