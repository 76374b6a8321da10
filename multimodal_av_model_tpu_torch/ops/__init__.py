"""Compute primitives: the log-mel (K1) and lip-preprocess (K2) kernels with
their plain versions, the CTC loss, collapse and greedy decode, prefix beam
search (offline and streaming), the reference path beam, int8 weight-only
quantization, the masked contrastive loss, SpecAugment, the masked-span
InfoNCE and the error-rate counts."""

from .metrics import cer, wer

__all__ = ["cer", "wer"]
