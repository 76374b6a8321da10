"""Whisper-Flamingo's decoder, forward: the embedding, the 32 layers with
their gated blocks and the f32 logits (models/whisper_flamingo.py:
``WhisperTextDecoder``).  Device-stream time between CUDA events from forward
hooks on the module, ms per training step."""

from ._spans import per_unit_ms


def read(records: dict, kind: str | None):
    return per_unit_ms(records, "wf_decoder", kind)
