"""A traced run of one cell with the program's own recorder on, and the
reduction of a profiled stretch under the program's spans.

    python3 -m avbench.program --workload av_flagship.train_b8 --seed 7 --seconds 40

prints the line of ``avbench.run --trace 1`` with, besides, the per-layer
metrics that read the program's spans and counters
(``multimodal_av_model_tpu_torch/tracing.py``; ``METRICS``),
``info.spans`` (per span name and unit: how many, host and device ms and
host syncs in the window, launches and device idle ms in the profiled
stretch) and ``info.idle_gaps_by_span`` (the ten longest idle gaps of
``breakdown.idle_gaps``, in its order, each under the innermost span open
at its middle).  The run is ``harness.run``'s traced run: the recorder is
turned on after set-up, each unit is opened as ``tracing.unit(i)``, the
window's spans are collected before the profiled stretch and its own after
it, and the stretch's profiler events are kept with the spans' ranges.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import io
import json
import sys
import time
from collections import defaultdict

from . import harness, trace

# The CUDA launch calls (`cuda*` and `cu*` APIs), as the profiler names them.
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
OUTSIDE = "(outside any span)"

METRICS = {
    "train": [("forward_ms.train", "ms"), ("losses_ms.train", "ms"),
              ("backward_ms.train", "ms"), ("optimizer_ms.train", "ms"),
              ("h2d_ms.train", "ms"), ("host_syncs.train", "count"),
              ("kernel_launches.train", "count")],
    "transcribe": [("h2d_ms.transcribe", "ms"), ("host_syncs.transcribe", "count"),
                   ("kernel_launches.transcribe", "count"), ("decode_idle.transcribe", "%")],
}


def by_span(events, names, top: int = 10) -> dict:
    """``events``: ``(kind, name, start_us, end_us)``, kind "device", "host"
    or "span" (a user range: those named in ``names`` are the program's
    spans, the others, such as ``torch.optim``'s, are left out).  Returns
    ``launches`` (the launch calls of the whole stretch), ``spans`` (per
    name: ``n``, ``ms`` of range, ``launches`` on the host inside the
    ranges, ``idle_ms``: range minus the union of device operations within
    it) and ``idle_gaps``
    (``reduce_profile``'s longest gaps in its order, as ``[span, seconds]``
    under the innermost span open at the gap's middle)."""
    busy = trace.merge([(s, e) for k, _, s, e in events if k == "device"])
    starts = [b[0] for b in busy]
    launch_at = sorted(s for k, n, s, _ in events if k == "host" and n in LAUNCHES)
    ranges = [(s, e, n) for k, n, s, e in events if k == "span" and n in names]

    def busy_within(s, e):
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        total = 0.0
        while i < len(busy) and busy[i][0] < e:
            total += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
        return total

    spans: dict[str, dict] = defaultdict(lambda: {"n": 0, "ms": 0.0, "launches": 0,
                                                  "idle_ms": 0.0})
    for s, e, n in ranges:
        row = spans[n]
        row["n"] += 1
        row["ms"] += (e - s) / 1e3
        row["launches"] += bisect.bisect_right(launch_at, e) - bisect.bisect_left(launch_at, s)
        row["idle_ms"] += (e - s - busy_within(s, e)) / 1e3
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:top]
    idle = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        inside = [r for r in ranges if r[0] <= mid <= r[1]]
        idle.append([min(inside, key=lambda r: r[1] - r[0])[2] if inside else OUTSIDE,
                     length / 1e6])
    return {"launches": len(launch_at), "spans": dict(spans), "idle_gaps": idle}


def profile(run, n: int, device: str = "cuda") -> tuple[dict, list]:
    """``trace.profile`` keeping the program's ranges: ``run(i)`` for ``i <
    n`` under ``torch.profiler`` -> ``(reduce_profile's dict, events)``,
    the events with the spans' ranges as kind "span"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        sync()
        wall = time.perf_counter() - t0
    events = []
    for e in prof.events():
        on_device = e.device_type == DeviceType.CUDA
        if getattr(e, "is_user_annotation", False):
            if on_device:
                continue
            kind = "span"
        else:
            kind = "device" if on_device else "host"
        events.append((kind, e.name, e.time_range.start, e.time_range.end))
    return trace.reduce_profile([x for x in events if x[0] != "span"], wall), events


@contextlib.contextmanager
def recorder_on(runner, kept: dict):
    """Inside, ``harness.run``'s traced run has the program's recorder on
    from ``attach`` to the end of the profiled stretch; ``kept`` gets
    ``window`` and ``profiled`` (``tracing.collect()`` of each) and
    ``events`` (the stretch's, with the spans' ranges)."""
    from multimodal_av_model_tpu_torch import tracing

    Job = runner.Job
    attach, unit, trace_profile = Job.attach, Job.unit, trace.profile

    def attach_on(job, spans):
        attach(job, spans)
        tracing.enable(job.device)

    def unit_in(job, i, spans=None):
        with tracing.unit(i):
            unit(job, i, spans)

    def profile_kept(run, n, device="cuda"):
        kept["window"] = tracing.collect()
        out, kept["events"] = profile(run, n, device)
        kept["profiled"], kept["profiled_units"] = tracing.collect(), n
        tracing.disable()
        return out

    Job.attach, Job.unit, trace.profile = attach_on, unit_in, profile_kept
    try:
        yield kept
    finally:
        Job.attach, Job.unit, trace.profile = attach, unit, trace_profile
        tracing.disable()


def records(kind: str, units: int, kept: dict) -> dict:
    """What the readers of ``METRICS`` read: the window's spans over its
    ``units``, and the profiled stretch's spans and reduction."""
    return {"kind": kind, "units": units,
            "program": {"window": kept["window"], "profiled": kept["profiled"],
                        "profiled_units": kept["profiled_units"],
                        **by_span(kept["events"], {s["name"] for s in kept["profiled"]})}}


def span_table(rec: dict) -> dict:
    """``info.spans``: per span name, per unit, the window's count, host and
    device ms and host syncs, and the stretch's launches and idle ms."""
    from multimodal_av_model_tpu_torch import tracing

    prog = rec["program"]
    table = tracing.summary(prog["window"], max(rec["units"], 1))
    per = max(prog["profiled_units"], 1)
    for name, row in prog["spans"].items():
        table.setdefault(name, {}).update(launches=row["launches"] / per,
                                          idle_ms=row["idle_ms"] / per)
    return table


def main(argv=None) -> int:
    """``avbench.run --trace 1`` with the recorder on; the line gains
    ``METRICS``, ``info.spans`` and ``info.idle_gaps_by_span``."""
    from avbench import run as run_mod

    argv = list(sys.argv[1:] if argv is None else argv)
    workload = argv[argv.index("--workload") + 1]
    cell = harness.Cell.find(workload)
    kind = cell.mix["runner"]
    runner = importlib.import_module(f"avbench.runners.{kind}")
    kept, got = {}, {}
    inner = harness.run

    def run_kept(*args, **kwargs):
        got.update(inner(*args, **kwargs))
        return got

    printed = io.StringIO()
    harness.run = run_kept
    try:
        with recorder_on(runner, kept), contextlib.redirect_stdout(printed):
            rc = run_mod.main(argv + ["--trace", "1"])
    finally:
        harness.run = inner
    if rc != 0:
        return rc
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    rec = records(kind, got["units"], kept)
    for name, unit in METRICS[kind]:
        value = harness.read_metric({"name": name}, rec)
        if value is not None:
            line["metrics"][name] = {"value": value, "unit": unit}
    line["info"]["spans"] = span_table(rec)
    line["info"]["idle_gaps_by_span"] = rec["program"]["idle_gaps"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
