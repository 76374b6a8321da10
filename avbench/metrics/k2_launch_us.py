"""K2, the lip kernel (csrc/lip_preprocess.cu): mean device time of its
launches in the profiled stretch, in microseconds.  No roofline share: on
this path K2 reads crops that the copy before it has just left in the 50 MB
L2, and beats the HBM bound of its bytes."""


def read(records: dict, kind: str | None):
    tr = records.get("trace")
    if kind != records["kind"] or not tr:
        return None
    times = tr["kernels"].get("lip_kernel") or []
    return 1e6 * sum(times) / len(times) if times else None
