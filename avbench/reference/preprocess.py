"""Raw collated batch -> model inputs, in plain float32.

Mixing: the two waveforms are summed over their true lengths and divided by
``max|mix| + 1e-6``; each speaker's mask codes 0 other speaker solo, 1
overlap, 2 target solo, 3 padding.  Lips: the channel mean of each uint8
frame, a bilinear resize with OpenCV's ``INTER_LINEAR`` sample positions
(half-pixel centres, clamped at the edges), divided by 255.  Log-mel: a
centred (reflect-padded) STFT with a periodic Hann window, the power
spectrum, an HTK triangular filterbank without normalisation, ``log(x +
eps)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PAD, OTHER_SOLO, OVERLAP, TARGET_SOLO = 3, 0, 1, 2


def mix(audio1, audio2, len1, len2):
    """``[B, S]`` waveforms and ``[B]`` lengths -> ``(mixed, mask1, mask2)``."""
    S = audio1.shape[1]
    pos = torch.arange(S, device=audio1.device)[None, :]
    in1, in2 = pos < len1[:, None].long(), pos < len2[:, None].long()
    mixed = torch.where(in1, audio1, 0.0) + torch.where(in2, audio2, 0.0)
    mixed = mixed / (mixed.abs().amax(dim=1, keepdim=True) + 1e-6)
    pad = pos >= torch.maximum(len1, len2)[:, None].long()

    def code(inside):
        m = torch.where(in1 & in2, OVERLAP, torch.where(inside, TARGET_SOLO, OTHER_SOLO))
        return torch.where(pad, PAD, m)

    return mixed, code(in1), code(in2)


def resize_weights(out_size: int, in_size: int) -> np.ndarray:
    """``[out, in]`` bilinear weights at OpenCV's sample positions, in float64."""
    src = np.clip((np.arange(out_size) + 0.5) * in_size / out_size - 0.5, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = np.zeros((out_size, in_size))
    np.add.at(w, (np.arange(out_size), lo), 1.0 - (src - lo))
    np.add.at(w, (np.arange(out_size), hi), src - lo)
    return w


def lips(frames: torch.Tensor, out_size: int = 96) -> torch.Tensor:
    """``[B, T, H, W, C]`` uint8 -> ``[B, T, 1, out, out]`` float32 in 0..1."""
    B, T, H, W, _ = frames.shape
    grey = frames.to(torch.float32).mean(dim=-1)
    rh = torch.from_numpy(resize_weights(out_size, H)).to(grey)
    rw = torch.from_numpy(resize_weights(out_size, W)).to(grey)
    out = rh @ grey @ rw.T
    return (out / 255.0).reshape(B, T, 1, out_size, out_size)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float,
                   f_max: float) -> np.ndarray:
    """HTK triangular filters ``[n_freqs, n_mels]``, no normalisation."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    freqs = np.linspace(0, sample_rate // 2, n_freqs)
    pts = 700.0 * (10.0 ** (np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2) / 2595.0) - 1)
    diff = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    return np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]))


def log_mel(wave: torch.Tensor, fe: dict) -> torch.Tensor:
    """``[B, S]`` -> ``[B, frames, n_mels]``."""
    n_fft, hop = fe["n_fft"], fe["hop_length"]
    x = wave.to(torch.float32)
    if fe["center"]:
        x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)
    n = torch.arange(fe["win_length"], dtype=torch.float64, device=x.device)
    window = (0.5 - 0.5 * torch.cos(2 * torch.pi * n / fe["win_length"])).float()
    lpad = (n_fft - fe["win_length"]) // 2
    window = F.pad(window, (lpad, n_fft - fe["win_length"] - lpad))
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    f_max = fe["f_max"] if fe["f_max"] is not None else fe["sample_rate"] / 2
    fb = mel_filterbank(n_fft // 2 + 1, fe["n_mels"], fe["sample_rate"], fe["f_min"], f_max)
    return torch.log(power @ torch.from_numpy(fb).to(power) + fe["log_eps"])


def model_inputs(raw: dict, device, out_size: int = 96) -> dict:
    """A raw collated batch (numpy) -> the reference model's inputs on ``device``."""
    def t(key):
        return torch.from_numpy(np.ascontiguousarray(raw[key])).to(device)

    mixed, mask1, mask2 = mix(t("audio1").float(), t("audio2").float(),
                              t("audio1_len"), t("audio2_len"))
    return {"lip1": lips(t("lip1_raw"), out_size), "lip2": lips(t("lip2_raw"), out_size),
            "audio": mixed, "mask1": mask1, "mask2": mask2,
            "lip1_len": t("lip1_lengths").long(), "lip2_len": t("lip2_lengths").long()}
