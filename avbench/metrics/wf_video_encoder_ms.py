"""Whisper-Flamingo's video encoder, forward: AV-HuBERT Large on video alone
(models/whisper_flamingo.py: ``VideoEncoder``; the ResNet-18 trunk, the
fusion, the positional convolution and the 24 layers).  Device-stream time
between CUDA events from forward hooks on the module, ms per training step."""

from ._spans import per_unit_ms


def read(records: dict, kind: str | None):
    return per_unit_ms(records, "wf_video_encoder", kind)
