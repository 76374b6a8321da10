"""Peaks of one NVIDIA H100 SXM and the least work of the log-mel kernel (K1).

Peaks, dense, from NVIDIA's data sheet at the 700 W limit: 989 TFLOP/s in
bfloat16 on the tensor cores, 495 in TF32, 67 in float32 on the CUDA cores,
3.35 TB/s of HBM3.  A kernel's least time is the larger of its least
operations over the float32 peak and its bytes (each input byte read once,
each output byte written once) over the HBM rate.  The lip kernel (K2) has
none here: on the benchmark's paths its input sits in L2 after the copy
before it, and it beats its HBM bound.
"""

from __future__ import annotations

import math

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def least_seconds(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> float:
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def fft_flops(n: int) -> float:
    """A real-input FFT of ``n`` points: half the ``5 n log2 n`` of a complex one."""
    return 2.5 * n * math.log2(n)


def mel_nonzeros(n_freqs: int, n_mels: int, sample_rate: int, f_min: float,
                 f_max: float | None) -> int:
    """Nonzero weights of the HTK filterbank (the mel step's least work)."""
    from .reference.preprocess import mel_filterbank

    f_max = f_max if f_max is not None else sample_rate / 2
    return int(np.count_nonzero(mel_filterbank(n_freqs, n_mels, sample_rate, f_min, f_max)))


def k1(B: int, S: int, fe: dict) -> tuple[float, float]:
    """Log-mel of ``[B, S]`` float32 samples -> ``(least flops, bytes)``: window,
    real FFT, power, the mel projection over the filterbank's nonzeros and the
    log, per frame; bytes of the samples in and the ``[B, frames, n_mels]``
    float32 out."""
    n_fft = fe["n_fft"]
    frames = 1 + (S + (n_fft if fe["center"] else 0) - n_fft) // fe["hop_length"]
    bins = n_fft // 2 + 1
    nnz = mel_nonzeros(bins, fe["n_mels"], fe["sample_rate"], fe["f_min"], fe["f_max"])
    flops = B * frames * (n_fft + fft_flops(n_fft) + 3 * bins + 2 * nnz + fe["n_mels"])
    return flops, B * S * 4 + B * frames * fe["n_mels"] * 4

