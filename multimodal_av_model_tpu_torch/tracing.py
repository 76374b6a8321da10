"""The port's spans and counters: one recorder, off unless turned on.

    from multimodal_av_model_tpu_torch import tracing

    tracing.enable()                 # or inside train/profiling.trace(log_dir)
    with tracing.unit(7):            # a request or a step
        texts = transcriber.transcribe(batch)
    spans = tracing.collect()        # resolves the CUDA events, empties the recorder
    tracing.disable()

**Off** (the default) ``span`` and ``unit`` check one module flag and return
the shared no-op context ``OFF``, and ``count`` returns at once: no
allocation, no CUDA event, no ``record_function``.

**On**, each ``span(name)`` records its host interval
(``time.perf_counter_ns``), a CUDA event pair on the current stream when the
recorder was turned on for the card, and a ``torch.profiler.record_function``
range, so that under a profiler every span lies on the device trace's own
clock.  The stack of open spans is per thread (``serve.DynamicBatcher``
calls from a worker), and each span carries the calling thread's unit id.
A span records nothing while ``torch.compile`` or ``torch.export`` traces
(its range would enter the graph), and no CUDA event while the stream is
being captured into a CUDA graph.  Spans stay in memory until ``collect``.

``count(name, n)`` adds to a counter of the innermost open span of the
calling thread (outside every span it is dropped); ``count(name, n,
thread=ident)`` to that of the thread ``ident`` instead, for work another
thread does on its behalf (autograd's device thread runs a CUDA backward
while its caller waits in ``train.backward``), and so does every ``count``
inside ``counting_for(ident)`` (a checkpointed region recomputed there).
On the card the recorder sets ``torch.cuda.set_sync_debug_mode("warn")``
and counts each synchronising call (a blocking copy either way, ``.cpu()``,
``.item()``, a stream synchronise) as ``host_syncs`` of the innermost span
instead of printing it; ``disable`` restores the previous mode.

The spans the program opens, and where (``avbench/metrics`` reads them by
name; about 20 a unit, none inside a per-frame loop):

=======================  ===================================================
``preprocess``           ``data/device_pipeline.py:preprocess_batch_device``
``preprocess.h2d``       each host-to-device copy of a raw input (``_on``)
``preprocess.mix``       ``mix_pair_batched_device``: mixing and masks
``preprocess.lips``      K2 on one speaker's crops, after their copy
``transcribe``           ``infer.py:Transcriber.transcribe``, a request
``transcribe.forward``   its model call
``transcribe.decode``    its ``decode_ids``: on the card one K3 launch,
                         counted as ``prefix_beam_kernel``
``transcribe.readback``  its ``_texts``: ids to the host, the tokenizer
``train.step``           ``train/trainer.py:train_step``, zero_grad included
``train.forward``        the model call in ``_losses``
``train.losses``         the rest of ``_losses``: contrastive and CTC terms
``train.backward``       ``total.backward()``
``train.optimizer``      the gradient norm and ``GroupAdam.step``
``train.allreduce``      ``_average_grads``: the gradient all-reduce of a
                         meshed step without FSDP
``encoders.visual``,     ``models/av_model.py:MultiSpeakerAVModel.forward``
``encoders.audio``,      and ``models/avhubert.py:AVHubertCTC.forward``;
``fusion``, ``decoder``  each bf16 or f16 ``BatchNorm`` call
                         (``models/layers.py``) counted as ``bn_one_pass``,
                         and a recomputed one's under ``train.backward``
``fusion.temporal``      the BiLSTM or transformer call in ``models/fusion.py``;
                         each ``mmav::lstm_scan`` call (on the card one K4
                         launch), counted as ``lstm_kernel``, and its
                         backward's under ``train.backward``
``encoders.layers``      AV-HuBERT's transformer layers (``AVHubertCTC``)
=======================  ===================================================
"""

from __future__ import annotations

import contextlib
import itertools
import re
import threading
import time
import warnings

import torch

OFF = contextlib.nullcontext()

_ON = False
_CUDA = False
_SYNC_MESSAGE = "called a synchronizing CUDA operation"
_tls = threading.local()
_records: list["_Span"] = []
_open: dict[int, list] = {}            # the stacks of the threads with spans open, by thread id
_ids = itertools.count()
# While syncs are counted: (the previous sync debug mode, the warnings state, showwarning).
_saved = None


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class _Span:
    __slots__ = ("id", "name", "parent", "unit", "start_ns", "end_ns", "events", "counters",
                 "_range")

    def __init__(self, name: str):
        self.name, self.counters, self.events = name, {}, None

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.unit = getattr(_tls, "unit", None)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if _CUDA and not torch.cuda.is_current_stream_capturing():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        if not stack:
            _open[threading.get_ident()] = stack
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        if not stack:
            _open.pop(threading.get_ident(), None)
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        _records.append(self)
        return False


def span(name: str):
    """A named range of the program: ``with span("train.backward"): ...``."""
    if not _ON or torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return OFF
    return _Span(name)


def count(name: str, n: int = 1, thread: int | None = None) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span of the calling
    thread, or of ``thread`` (its ``threading.get_ident()``) for work done on
    its behalf in another thread."""
    if _ON:
        if thread is None:
            thread = getattr(_tls, "counts_for", None)
        stack = _stack() if thread is None else _open.get(thread)
        if stack:
            c = stack[-1].counters
            c[name] = c.get(name, 0) + n


@contextlib.contextmanager
def _unit(uid):
    before = getattr(_tls, "unit", None)
    _tls.unit = uid
    try:
        yield
    finally:
        _tls.unit = before


@contextlib.contextmanager
def counting_for(thread: int):
    """Inside, the calling thread's ``count`` calls count for ``thread`` (a
    ``threading.get_ident()``), as ``count(..., thread=thread)`` would."""
    before = getattr(_tls, "counts_for", None)
    _tls.counts_for = thread
    try:
        yield
    finally:
        _tls.counts_for = before


def unit(uid):
    """Every span the calling thread opens inside carries ``uid`` (a request
    or step identifier)."""
    return _unit(uid) if _ON else OFF


def enabled() -> bool:
    return _ON


def _show(message, category, filename, lineno, file=None, line=None):
    if _SYNC_MESSAGE in str(message):
        count("host_syncs")
    else:
        _saved[2](message, category, filename, lineno, file, line)


def enable(device: str | None = None) -> None:
    """Turn the recorder on; ``device``: "cuda" records CUDA event pairs and
    counts host syncs (default: when there is a card)."""
    global _ON, _CUDA, _saved
    if _ON:
        return
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    _CUDA = torch.device(device).type == "cuda"
    if _CUDA:
        # Setting the mode may warn itself: only the calls in between go to _show.
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        state = warnings.catch_warnings()
        state.__enter__()
        _saved = (mode, state, warnings.showwarning)
        warnings.filterwarnings("always", message=re.escape(_SYNC_MESSAGE))
        warnings.showwarning = _show
    _ON = True


def disable() -> None:
    """Turn the recorder off (what it recorded stays until ``collect``)."""
    global _ON, _CUDA, _saved
    _ON = _CUDA = False
    if _saved is not None:
        mode, state, _ = _saved
        state.__exit__(None, None, None)
        _saved = None
        torch.cuda.set_sync_debug_mode(mode)


def collect() -> list[dict]:
    """The spans closed since the last call, in the order they opened, each
    ``{id, name, parent, unit, start_ns, end_ns, host_ms, device_ms,
    counters}`` (``device_ms`` None without an event pair); empties the
    recorder.  Synchronises the card where a span holds events."""
    done = sorted(_records[:], key=lambda s: s.id)
    del _records[: len(done)]
    if any(s.events is not None for s in done):
        torch.cuda.synchronize()
    return [{"id": s.id, "name": s.name, "parent": s.parent, "unit": s.unit,
             "start_ns": s.start_ns, "end_ns": s.end_ns,
             "host_ms": (s.end_ns - s.start_ns) / 1e6,
             "device_ms": s.events[0].elapsed_time(s.events[1]) if s.events else None,
             "counters": s.counters} for s in done]


def summary(spans: list[dict], units: int = 1) -> dict:
    """``collect``'s spans by name: how many, host and device ms and each
    counter, each summed and divided by ``units``."""
    out: dict[str, dict] = {}
    for s in spans:
        row = out.setdefault(s["name"], {"n": 0, "host_ms": 0.0, "device_ms": 0.0})
        row["n"] += 1
        row["host_ms"] += s["host_ms"]
        row["device_ms"] += s["device_ms"] or 0.0
        for k, v in s["counters"].items():
            row[k] = row.get(k, 0) + v
    return {name: {k: v / units for k, v in row.items()} for name, row in out.items()}
