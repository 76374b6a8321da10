"""Whisper-Flamingo's 32 gated cross-attention blocks, forward
(models/whisper_flamingo.py: ``GatedCrossAttention``): device-stream time
between CUDA events from forward hooks on each block, summed, ms per training
step."""

from ._spans import per_unit_ms


def read(records: dict, kind: str | None):
    return per_unit_ms(records, "wf_xattn", kind)
