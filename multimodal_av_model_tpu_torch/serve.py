"""Online serving: dynamic batching and an HTTP front end.

Own copy of ``multimodal_av_model_tpu/serve.py`` (framework-free; it reaches
the device only through the transcriber it wraps):

* ``DynamicBatcher``: concurrent ``submit`` calls coalesced into one call of
  ``infer_fn`` on a worker thread (up to ``max_batch`` items, after waiting
  at most ``max_wait_ms`` for more), with an optional bounded queue
  (``Overloaded``) and queue deadline (``DeadlineExceeded``); an exception
  of ``infer_fn`` fails that batch's requests and the worker keeps serving;
* ``AudioService``: waveforms resampled to 16 kHz, padded or trimmed to
  ``max_seconds`` with a valid-sample mask, and batched at one static
  ``[max_batch, S]`` shape through an ``infer.AudioTranscriber`` (fp or int8);
* ``serve_http``: a stdlib ``ThreadingHTTPServer``: ``POST /transcribe``
  (WAV body, or raw f32 PCM with ``X-Sample-Rate``) -> ``{"text",
  "latency_ms"}``, ``GET /healthz`` -> the batcher's counters.
"""

from __future__ import annotations

import dataclasses
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Sequence


class Overloaded(RuntimeError):
    """Queue-depth admission rejection: the request was never enqueued.
    HTTP surface maps this to 503 + Retry-After (load shedding)."""


class DeadlineExceeded(TimeoutError):
    """The request waited in queue past its deadline and was shed before
    touching the device (its slot goes to a fresher request instead)."""


@dataclasses.dataclass
class BatcherStats:
    requests: int = 0
    batches: int = 0
    rows_padded: int = 0
    shed_queue_full: int = 0
    shed_deadline: int = 0

    @property
    def mean_batch(self) -> float:
        return self.requests / self.batches if self.batches else 0.0


class DynamicBatcher:
    """Coalesce concurrent ``submit`` calls into ``infer_fn`` batches.

    ``infer_fn(items: list) -> list`` is called from ONE worker thread with
    1..max_batch items (device work needs no internal locking).  Batch
    formation: block for the first request, then drain whatever else has
    arrived within ``max_wait_ms``.  Under load the wait never triggers —
    the next batch forms while the device runs the previous one; when idle a
    lone request pays at most ``max_wait_ms`` extra latency.

    Overload protection (both off by default for embedded use; the HTTP
    server enables them):

    * ``max_queue`` bounds the number of waiting requests.  ``submit`` on a
      full queue raises ``Overloaded`` immediately — without a bound the
      queue grows without limit at offered load above capacity and EVERY
      request's latency diverges.
    * ``deadline_ms`` sheds requests that waited in queue longer than this
      before execution (``DeadlineExceeded``).  Queue-wait is the one
      unbounded latency term; with both knobs on, ADMITTED requests have
      bounded latency: <= deadline + batch-formation + one device forward.
    """

    def __init__(self, infer_fn: Callable[[list], list], max_batch: int = 32,
                 max_wait_ms: float = 10.0, max_queue: int | None = None,
                 deadline_ms: float | None = None):
        self.infer_fn = infer_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.deadline_s = float(deadline_ms) / 1000.0 if deadline_ms else None
        self.stats = BatcherStats()
        self._q: queue.Queue = queue.Queue(maxsize=int(max_queue or 0))
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item: Any) -> Future:
        if self._closed:
            raise RuntimeError("batcher is closed")
        fut: Future = Future()
        try:
            self._q.put_nowait((item, fut, time.monotonic()))
        except queue.Full:
            self.stats.shed_queue_full += 1
            raise Overloaded(
                f"queue full ({self._q.maxsize} waiting); retry later"
            ) from None
        return fut

    def __call__(self, item: Any, timeout: float | None = None) -> Any:
        return self.submit(item).result(timeout)

    def close(self, timeout: float = 5.0) -> None:
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout)

    def _expired(self, entry) -> bool:
        """Shed a queue-expired request (never reaches the device)."""
        if self.deadline_s is None:
            return False
        _, fut, t_enq = entry
        if time.monotonic() - t_enq <= self.deadline_s:
            return False
        self.stats.shed_deadline += 1
        fut.set_exception(DeadlineExceeded(
            f"spent > {self.deadline_s * 1000:.0f} ms in queue"))
        return True

    def _loop(self) -> None:
        while True:
            head = self._q.get()
            if head is None:
                return
            if self._expired(head):
                continue
            pairs = [head]
            deadline = time.monotonic() + self.max_wait_s
            while len(pairs) < self.max_batch:
                remaining = deadline - time.monotonic()
                try:
                    nxt = self._q.get(timeout=max(remaining, 0.0))
                except queue.Empty:
                    break
                if nxt is None:
                    self._finish(pairs)
                    return
                if not self._expired(nxt):
                    pairs.append(nxt)
            self._finish(pairs)

    def _finish(self, pairs: list) -> None:
        items = [p[0] for p in pairs]
        try:
            results = self.infer_fn(items)
            if len(results) != len(items):
                raise RuntimeError(
                    f"infer_fn returned {len(results)} results for "
                    f"{len(items)} items")
        except BaseException as e:  # propagate per-request, keep serving
            for _, fut, _ in pairs:
                fut.set_exception(e)
            return
        self.stats.requests += len(pairs)
        self.stats.batches += 1
        self.stats.rows_padded += self.max_batch - len(pairs)
        for (_, fut, _), r in zip(pairs, results):
            fut.set_result(r)


class AudioService:
    """Waveform -> transcript through a shared static-shape device batch.

    Wraps an ``infer.AudioTranscriber`` (fp or int8-quantized): requests are
    resampled to 16 kHz, padded/trimmed to ``max_seconds`` with a per-sample
    valid mask, and batched by a ``DynamicBatcher`` at ONE static
    ``[max_batch, S]`` shape.
    """

    def __init__(self, transcriber, max_batch: int = 32,
                 max_seconds: float = 16.0, max_wait_ms: float = 10.0,
                 use_beam: bool = True, sample_rate: int = 16000,
                 max_queue: int | None = None,
                 deadline_ms: float | None = None):
        from .config import require_flagship

        require_flagship(getattr(getattr(transcriber, "config", None), "model", None),
                         "the audio service")
        import numpy as np

        self._np = np
        self.transcriber = transcriber
        self.sample_rate = int(sample_rate)
        self.samples = int(max_seconds * sample_rate)
        self.max_batch = int(max_batch)
        self.use_beam = use_beam
        self.batcher = DynamicBatcher(self._infer, max_batch, max_wait_ms,
                                      max_queue=max_queue,
                                      deadline_ms=deadline_ms)

    def transcribe(self, wave, rate: int | None = None,
                   timeout: float | None = 60.0) -> str:
        return self.submit(wave, rate).result(timeout)

    def submit(self, wave, rate: int | None = None) -> Future:
        np = self._np
        wave = np.asarray(wave, np.float32)
        if rate and rate != self.sample_rate:
            from .data.audio_io import resample

            wave = resample(wave, rate, self.sample_rate)
        return self.batcher.submit(wave[: self.samples])

    def close(self) -> None:
        self.batcher.close()

    def _infer(self, waves: Sequence) -> list:
        np = self._np
        n = len(waves)
        audio = np.zeros((self.max_batch, self.samples), np.float32)
        mask = np.zeros((self.max_batch, self.samples), bool)
        for i, w in enumerate(waves):
            audio[i, : len(w)] = w
            mask[i, : len(w)] = True
        texts = self.transcriber.transcribe(audio, mask, use_beam=self.use_beam)
        return list(texts[:n])


def serve_http(service: AudioService, host: str = "127.0.0.1",
               port: int = 8080, block: bool = True):
    """JSON/WAV HTTP front end (stdlib only).

    ``POST /transcribe`` with a WAV body (or raw float32 PCM with
    ``X-Sample-Rate``) -> ``{"text": ..., "latency_ms": ...}``;
    ``GET /healthz`` -> batcher stats.  Threaded: each connection blocks on
    its own future, the batcher coalesces them onto the device.
    Returns the server object; ``block=False`` runs it on a daemon thread
    (tests, embedding).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._send(404, {"error": "not found"})
            st = service.batcher.stats
            self._send(200, {"ok": True, "requests": st.requests,
                             "batches": st.batches,
                             "mean_batch": round(st.mean_batch, 2),
                             "shed_queue_full": st.shed_queue_full,
                             "shed_deadline": st.shed_deadline})

        def do_POST(self):
            if self.path != "/transcribe":
                return self._send(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                rate_hdr = self.headers.get("X-Sample-Rate")
                if rate_hdr:  # raw little-endian float32 PCM
                    import numpy as np

                    wave = np.frombuffer(raw, np.float32)
                    rate = int(rate_hdr)
                else:
                    from .data.audio_io import read_wav

                    wave, rate = read_wav(io.BytesIO(raw))
                t0 = time.monotonic()
                text = service.transcribe(wave, rate)
                self._send(200, {
                    "text": text,
                    "latency_ms": round((time.monotonic() - t0) * 1000, 1)})
            except Overloaded as e:
                # Load shedding: bounded queue refused admission.  503 +
                # Retry-After so well-behaved clients back off.
                self.send_response(503)
                body = json.dumps({"error": f"overloaded: {e}"}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(body)
            except DeadlineExceeded as e:
                self._send(503, {"error": f"shed after queueing: {e}"})
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    if block:
        server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
