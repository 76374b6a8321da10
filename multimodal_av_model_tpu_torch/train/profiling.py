"""Tracing, profiling and numerical guards of the train loop.

Mirrors ``multimodal_av_model_tpu/train/profiling.py:28-77``:

* ``trace(log_dir)``: ``torch.profiler`` over the block, with CUDA activity
  when the device is the card, writing a ``*.pt.trace.json`` that
  TensorBoard's profiler plugin and Perfetto load (JAX: ``jax.profiler``).
  It turns the port's recorder (``tracing``) on for the block, so the
  program's spans are ranges of the trace;
* ``annotate(name)``: ``tracing.span``, a named range in the trace (JAX:
  ``jax.named_scope``).  The JAX package names no block of its own; the
  port opens its spans at the layers of a request and of a training step
  (``tracing``'s table), and callers may label more;
* ``nan_guard()``: traps the first non-finite value: a forward hook on every
  module raises ``FloatingPointError`` naming the first module whose output
  is not finite, and anomaly mode raises at the first backward function that
  returns NaN.  The previous anomaly setting comes back on exit (JAX:
  ``jax_debug_nans``).  Debug runs only: every module's output is checked on
  the host;
* ``check_finite``: the train loop's raise on a non-finite metric;
* ``device_memory_stats()``: ``torch.cuda.memory_stats`` per visible card,
  keyed ``cuda:<i>``, ``None`` where a device gives none (``{"cpu": None}``
  without a card).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Iterator, Mapping

import torch

from .. import tracing


@contextlib.contextmanager
def trace(log_dir: str, device: str | None = None) -> Iterator[torch.profiler.profile]:
    """Profile everything inside the block into ``log_dir``, with the
    recorder on (unless it already was, what it recorded in the block is
    dropped at the end: the trace holds it); yields the profiler
    (``key_averages()`` after the block).  ``device``: ``cuda`` records the
    card's kernels too (default: when there is a card)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    owner = not tracing.enabled()
    tracing.enable(device)
    try:
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir),
                     record_shapes=False) as prof:
            yield prof
            if device == "cuda":
                torch.cuda.synchronize()
    finally:
        if owner:
            tracing.disable()
            tracing.collect()


def annotate(name: str):
    """A named range in the profiler's trace: ``with annotate("fusion"): ...``
    (``tracing.span``: a range while the recorder is on, as inside
    ``trace``)."""
    return tracing.span(name)


def _first_bad(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_floating_point() and not bool(torch.isfinite(value).all())
    if isinstance(value, dict):
        return any(_first_bad(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return any(_first_bad(v) for v in value)
    return False


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """Raise at the first non-finite module output (forward) or gradient
    (backward) inside the block."""
    def hook(module, args, output):
        if _first_bad(output):
            raise FloatingPointError(f"non-finite output of {type(module).__name__}")

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    prev = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    finally:
        handle.remove()
        torch.autograd.set_detect_anomaly(*prev)


class NonFiniteLossError(RuntimeError):
    pass


def check_finite(metrics: Mapping[str, object], step: int | None = None) -> None:
    """Raise with the offending keys if any metric is NaN or infinite."""
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    if bad:
        at = f" at step {step}" if step is not None else ""
        raise NonFiniteLossError(f"non-finite metrics{at}: {bad}")


def device_memory_stats() -> dict:
    """Per-card allocator statistics (``profiling.py:69-77``)."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) or None
            for i in range(torch.cuda.device_count())}
