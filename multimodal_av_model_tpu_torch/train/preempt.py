"""Preemption-safe training: SIGTERM/SIGINT become a flag that ``fit`` reads.

Own copy of ``multimodal_av_model_tpu/train/preempt.py:25-83``.  The handler
only sets the flag; ``train_epoch`` reads it before each step and ``fit``
then saves ``last.ckpt`` as the previous epoch and returns, so the saved
state is always one between steps.  A second signal restores the previous
handler and re-raises (a double Ctrl-C still kills).  Handlers can only be
installed from the main thread; elsewhere, or with ``enable=False``, the
flag is inert but ``request()`` still sets it.
"""

from __future__ import annotations

import signal
import threading


class GracefulShutdown:
    """``with GracefulShutdown() as stop: ... stop.requested``"""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, enable: bool = True):
        self._flag = threading.Event()
        self._enable = enable
        self._previous: dict[int, object] = {}
        self._installed = False

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    def request(self) -> None:
        self._flag.set()

    def _handler(self, signum, frame):
        if self._flag.is_set():
            self._restore()
            signal.raise_signal(signum)
            return
        self._flag.set()

    def __enter__(self) -> "GracefulShutdown":
        if self._enable and threading.current_thread() is threading.main_thread():
            for sig in self.SIGNALS:
                self._previous[sig] = signal.getsignal(sig)
                signal.signal(sig, self._handler)
            self._installed = True
        return self

    def _restore(self) -> None:
        if self._installed:
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._installed = False

    def __exit__(self, *exc) -> None:
        self._restore()
