"""Compute primitives: the log-mel (K1) and lip-preprocess (K2) kernels with
their plain versions, the CTC loss, collapse and greedy decode, prefix beam
search (offline and streaming) with its kernel (K3), the BiLSTM recurrence
(K4) and the plain masked recurrences, the reference path beam, int8
weight-only quantization, the masked contrastive loss, SpecAugment, the
masked-span InfoNCE and the error-rate counts.

``launch_counts`` is the one reader of the hand-written kernels' launches."""

from .metrics import cer, wer

__all__ = ["cer", "launch_counts", "wer"]


def launch_counts(since: dict[str, int] | None = None) -> dict[str, int]:
    """The launches of each hand-written kernel in this process: K1
    ``logmel``, K2 ``lip_preprocess``, K3 ``prefix_beam`` and K4
    ``lstm_scan`` (forward and backward).  Given ``since``, an earlier
    return, the launches made after it.  It reads the ``launches`` of each
    kernel's public entry, the counts' one store, which every launch adds to
    (``cuda_build.Launcher``); a plain version on the CPU adds nothing."""
    from . import logmel, lstm_scan, prefix_beam_search, resize

    now = {"logmel": logmel.log_mel_spectrogram_cuda.launches,
           "lip_preprocess": resize.lip_preprocess_cuda.launches,
           "prefix_beam": prefix_beam_search.prefix_beam.launches,
           "lstm_scan": lstm_scan.lstm_scan.launches}
    return now if since is None else {k: n - since[k] for k, n in now.items()}
