"""Floating-point operations of Whisper-Flamingo's training step (``model.arch
= "whisper_flamingo"``), counted from the configuration and the shapes at 2
operations per multiply-add, as ``avbench/flops.py`` counts the flagship's;
and the least work of K1 at Whisper's 80 Slaney bins.

Counted: every matrix product, convolution and attention product, the
logits, and the filterbank projection; elementwise work, norms, softmaxes,
the FFT and the cross-entropy are left out.  Work is counted at the padded
shapes the model computes: Whisper's whole window (``2 n_audio_ctx`` mel
frames, ``n_audio_ctx`` positions) on the ``B`` mixtures, the bucket's video
frames on the ``2B`` rows, the decoder's ``n`` positions (prompt and label
bucket) on the ``2B`` rows, every attention cell.  A training step counts
what the recipe must compute: every forward; in the backward the activation
gradients of the decoder and of the gated blocks (once the forward for a
frozen product, whose weight takes no gradient), the weight gradients of the
trainables (the gated blocks and the video projection: twice the forward
for a product whose input also needs its gradient, once for the video
projection, whose input is the frozen video encoder's output; the first
gated block's query projection reads its trainable LayerNorm, so it counts
twice like the rest); the
cross-attention over the audio needs only its query's gradient (its keys and
values are the frozen encoder's); the frozen encoders take no backward.
"""

from __future__ import annotations

import numpy as np

from . import flops_avhubert
from .roofline import fft_flops

VIDEO_PARTS = ("visual_frontend", "visual_trunk", "visual_proj", "fusion_proj", "pos_conv",
               "layers", "attention")


def forward_parts(cfg: dict, B: int, T: int, n: int, lip_size: int = 88) -> dict:
    """Forward operations of one batch of ``B`` mixtures (``2B`` decoder rows
    of ``n`` positions, ``T`` video frames) by part: ``{name: (flops,
    backward_factor)}``."""
    fe, w = cfg["frontend"], cfg["whisper_flamingo"]
    D, R, V = w["n_text_state"], 2 * B, w["n_vocab"]
    Da, Ta, La, Ld = w["n_audio_state"], w["n_audio_ctx"], w["n_audio_layer"], w["n_text_layer"]
    parts: dict[str, tuple[float, float]] = {}

    def add(name, flops, factor):
        f, k = parts.get(name, (0.0, factor))
        parts[name] = (f + flops, k)

    frames = 2 * Ta                 # K1 makes one more (centred), which Whisper drops
    add("filterbank", 2.0 * B * (frames + 1) * (fe["n_fft"] // 2 + 1) * fe["n_mels"], 0.0)
    add("audio_convs", 2.0 * B * (frames * fe["n_mels"] * 3 * Da + Ta * Da * 3 * Da), 0.0)
    add("audio_layers", La * 2.0 * B * Ta * (4 * Da * Da + 8 * Da * Da), 0.0)
    add("audio_attention", La * 2 * 2.0 * B * Ta * Ta * Da, 0.0)

    # The video encoder: AV-HuBERT's parts on the 2B rows (their S is unused).
    video = flops_avhubert.forward_parts({**cfg, "decoder": {"vocab_size": 0}}, B, T, 0,
                                         lip_size)
    add("video_encoder", sum(video[k][0] for k in VIDEO_PARTS if k in video), 0.0)
    add("video_proj", 2.0 * R * T * w["video_dim"] * D, 1.0)

    add("gated_proj", Ld * 2.0 * R * n * 2 * D * D, 2.0)
    add("gated_kv", Ld * 2.0 * R * T * 2 * D * D, 2.0)
    add("gated_attention", Ld * 2 * 2.0 * R * n * T * D, 2.0)
    add("gated_ff", Ld * 2.0 * R * n * 8 * D * D, 2.0)

    add("self_proj", Ld * 2.0 * R * n * 4 * D * D, 1.0)
    add("self_attention", Ld * 2 * 2.0 * R * n * n * D, 2.0)
    add("cross_proj", Ld * 2.0 * R * n * 2 * D * D, 1.0)
    add("cross_kv", Ld * 2.0 * B * Ta * 2 * Da * D, 0.0)
    add("cross_attention", Ld * 2 * 2.0 * R * n * Ta * D, 1.0)
    add("ff", Ld * 2.0 * R * n * 8 * D * D, 1.0)
    add("logits", 2.0 * R * n * D * V, 1.0)
    return parts


def forward(cfg: dict, B: int, T: int, n: int, lip_size: int = 88) -> float:
    return sum(f for f, _ in forward_parts(cfg, B, T, n, lip_size).values())


def train_step(cfg: dict, B: int, T: int, n: int, lip_size: int = 88) -> float:
    """Operations of one training step: the forward and the backward the
    recipe needs (module docstring)."""
    return sum(f * (1.0 + k) for f, k in forward_parts(cfg, B, T, n, lip_size).values())


def slaney_nonzeros(n_fft: int, n_mels: int, sample_rate: int) -> int:
    """Nonzero weights of the Slaney filterbank (the mel step's least work)."""
    from .reference.whisper_flamingo import slaney_filterbank

    return int(np.count_nonzero(slaney_filterbank(n_fft, n_mels, sample_rate)))


def k1(B: int, S: int, fe: dict) -> tuple[float, float]:
    """K1 on ``[B, S]`` float32 samples at the Slaney bins, its mel power out
    (``apply_log`` off: Whisper's epilogue is a pass of its own) -> ``(least
    flops, bytes)``: window, real FFT, power and the mel projection over the
    filterbank's nonzeros, per frame; bytes of the samples in and the ``[B,
    frames, n_mels]`` float32 out."""
    n_fft = fe["n_fft"]
    frames = 1 + (S + (n_fft if fe["center"] else 0) - n_fft) // fe["hop_length"]
    bins = n_fft // 2 + 1
    nnz = slaney_nonzeros(n_fft, fe["n_mels"], fe["sample_rate"])
    flops = B * frames * (n_fft + fft_flops(n_fft) + 3 * bins + 2 * nnz)
    return flops, B * S * 4 + B * frames * fe["n_mels"] * 4
