"""What a traced run records, and its reduction: spans around the layers and a
bounded ``torch.profiler`` stretch.

Spans come from the benchmark's side of the program's interfaces: host
clock around calls that end in a synchronise, and CUDA event pairs recorded
by forward pre- and post-hooks on the model's modules.  The profiler's
device events give the device's busy time as the union of their intervals
(overlapping kernels count once), the operations that took the most device
time, the longest idle gaps with the host operation running in each, and
the device time of each launch of a named kernel.
"""

from __future__ import annotations

import time
from collections import defaultdict


class Spans:
    """Named durations in seconds, and CUDA event pairs resolved later."""

    def __init__(self, device: str = "cuda"):
        self.device = device
        self.seconds: dict[str, list[float]] = defaultdict(list)
        self._events: list[tuple[str, object, object]] = []
        self._handles = []

    def add(self, name: str, seconds: float) -> None:
        self.seconds[name].append(seconds)

    def hook(self, name: str, module) -> None:
        """Time each forward of ``module`` on the device stream (on the host
        clock where the device is the CPU)."""
        import torch

        pending = []

        def stamp():
            if self.device != "cuda":
                return time.perf_counter()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event

        def pre(mod, args):
            pending.append(stamp())

        def post(mod, args, out):
            self._events.append((name, pending.pop(), stamp()))

        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def close(self) -> None:
        """Remove the hooks and resolve the events (after a synchronise)."""
        for h in self._handles:
            h.remove()
        self._handles = []
        for name, start, end in self._events:
            self.seconds[name].append(end - start if isinstance(start, float)
                                      else start.elapsed_time(end) / 1e3)
        self._events = []


def merge(intervals):
    """Union of ``(start, end)`` intervals -> sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_profile(events, wall_s: float, kernels=("logmel_kernel", "lip_kernel"),
                   top: int = 10) -> dict:
    """``events``: ``(kind, name, start_us, end_us)`` with kind "device" or
    "host"; ``wall_s``: the host clock over the profiled stretch.  Returns
    ``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` (each a list
    of ``[name, seconds]``, longest first) and, per kernel name, the device
    seconds of each launch."""
    import numpy as np

    dev = [(s, e, n) for k, n, s, e in events if k == "device"]
    host = [(s, e, n) for k, n, s, e in events if k == "host"]
    busy = merge([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_op: dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        by_op[n] += (e - s) / 1e6
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:top]
    hs = np.array([h[0] for h in host], dtype=np.float64)
    he = np.array([h[1] for h in host], dtype=np.float64)
    idle = []
    for length, s, e in gaps:
        mid = (s + e) / 2
        inside = np.nonzero((hs <= mid) & (he >= mid))[0] if len(hs) else []
        # The innermost host operation running at the gap's middle.
        label = (host[min(inside, key=lambda i: he[i] - hs[i])][2] if len(inside)
                 else "(no host operation)")
        idle.append([label, length / 1e6])
    return {
        "busy_s": busy_s,
        "window_s": wall_s,
        "device_ops": sorted(([n, t] for n, t in by_op.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": idle,
        "kernels": {k: [(e - s) / 1e6 for s, e, n in dev if k in n] for k in kernels},
    }


def profile(run, n: int, device: str = "cuda") -> dict:
    """``run(i)`` for ``i < n`` under ``torch.profiler`` (host and device),
    ending in a synchronise -> ``reduce_profile``'s dict."""
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
        if getattr(e, "is_user_annotation", False):
            continue
        kind = "device" if e.device_type == DeviceType.CUDA else "host"
        events.append((kind, e.name, e.time_range.start, e.time_range.end))
    return reduce_profile(events, wall)
