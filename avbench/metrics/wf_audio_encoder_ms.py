"""Whisper-Flamingo's audio side, forward: K1 at 80 Slaney bins, Whisper's
log-mel epilogue and the 32-layer audio encoder (models/whisper_flamingo.py:
``WhisperAudioEncoder``).  Device-stream time between CUDA events from forward
pre- and post-hooks on the module, ms per training step."""

from ._spans import per_unit_ms


def read(records: dict, kind: str | None):
    return per_unit_ms(records, "wf_audio_encoder", kind)
