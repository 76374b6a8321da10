"""STFT -> log-mel audio frontend: the plain PyTorch version and the wrapper of
its CUDA kernel (K1).

Mirrors ``multimodal_av_model_tpu/ops/logmel.py:34-147`` (filterbank, framing
and the plain ``log_mel_spectrogram``) and
``multimodal_av_model_tpu/ops/pallas/logmel_kernel.py:47-188`` (the fused
kernel, here ``csrc/logmel.cu``).  Semantics are torchaudio's: centred frames
with reflect padding, a periodic Hann window, the rFFT power, an HTK mel
filterbank without normalisation, then ``log(mel + 1e-6)``, all in f32.

``log_mel_spectrogram_cuda`` is the entry the audio encoder calls: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build


def hz_to_mel(f):
    """HTK mel scale."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                   f_max: float | None = None) -> np.ndarray:
    """Triangular HTK mel filterbank ``[n_freqs, n_mels]``, no normalisation
    (torchaudio's defaults)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def num_frames(n_samples: int, n_fft: int = 400, hop_length: int = 160,
               center: bool = True) -> int:
    """Frame count for a given sample count (host-side shape math)."""
    n = n_samples + (n_fft if center else 0)
    return 1 + (n - n_fft) // hop_length


def _reflect_pad(signal: torch.Tensor, pad: int) -> torch.Tensor:
    lead = signal.shape[:-1]
    x = F.pad(signal.reshape(-1, 1, signal.shape[-1]), (pad, pad), mode="reflect")
    return x.reshape(*lead, x.shape[-1])


def _hann(win_length: int, device) -> torch.Tensor:
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * torch.pi * n / win_length))


def stft_magsq(signal: torch.Tensor, n_fft: int = 400, hop_length: int = 160,
               win_length: int | None = None, center: bool = True) -> torch.Tensor:
    """Power spectrogram ``[..., n_frames, n_fft // 2 + 1]`` (float32)."""
    win_length = win_length or n_fft
    x = signal.to(torch.float32)
    if center:
        x = _reflect_pad(x, n_fft // 2)
    frames = x.unfold(-1, n_fft, hop_length)            # [..., T, n_fft]
    window = _hann(win_length, x.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


def log_mel_spectrogram(signal: torch.Tensor, sample_rate: int = 16000, n_fft: int = 400,
                        hop_length: int = 160, win_length: int | None = None,
                        n_mels: int = 80, f_min: float = 0.0, f_max: float | None = None,
                        log_eps: float = 1e-6, center: bool = True,
                        apply_log: bool = True) -> torch.Tensor:
    """Plain version of K1: log-mel features ``[..., n_frames, n_mels]``."""
    magsq = stft_magsq(signal, n_fft, hop_length, win_length, center)
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate,
                                         f_min, f_max)).to(magsq.device)
    mel = magsq @ fb
    return torch.log(mel + log_eps) if apply_log else mel


@functools.lru_cache(maxsize=8)
def _kernel_tables(n_fft: int, n_mels: int, sample_rate: int, f_min: float,
                   f_max: float | None, device: str):
    """Windowed cos/sin DFT bases ``[n_fft, F]`` and the filterbank ``[F, n_mels]``
    on ``device`` (``logmel_kernel.py:47-59,155-162``, without lane padding)."""
    n_freqs = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(n_freqs)) / n_fft
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    wcos = (window[:, None] * np.cos(ang).astype(np.float32)).astype(np.float32)
    wsin = (window[:, None] * -np.sin(ang).astype(np.float32)).astype(np.float32)
    fb = mel_filterbank(n_freqs, n_mels, sample_rate, f_min, f_max)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (wcos, wsin, fb))


@functools.lru_cache(maxsize=1)
def _library():
    """The built kernel library and its two C functions, typed."""
    lib = cuda_build.load("logmel")
    smem_bytes = lib.mmav_logmel_smem_bytes
    smem_bytes.argtypes, smem_bytes.restype = [ctypes.c_int] * 3, ctypes.c_int
    launch = lib.mmav_logmel_launch
    launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    launch.restype = ctypes.c_int
    return lib, smem_bytes, launch


def log_mel_spectrogram_cuda(signal: torch.Tensor, sample_rate: int = 16000,
                             n_fft: int = 400, hop_length: int = 160,
                             win_length: int | None = None, n_mels: int = 80,
                             f_min: float = 0.0, f_max: float | None = None,
                             log_eps: float = 1e-6, center: bool = True,
                             apply_log: bool = True) -> torch.Tensor:
    """K1: fused log-mel of a ``[B, S]`` (or ``[S]``) f32 waveform.

    A CUDA tensor launches ``csrc/logmel.cu`` and counts one launch in
    ``log_mel_spectrogram_cuda.launches``; a CPU tensor takes the plain
    ``log_mel_spectrogram``.  Raises on anything the kernel does not take.
    """
    win_length = win_length or n_fft
    if signal.device.type == "cpu":
        return log_mel_spectrogram(signal, sample_rate, n_fft, hop_length, win_length,
                                   n_mels, f_min, f_max, log_eps, center, apply_log)
    if signal.device.type != "cuda":
        raise ValueError(f"log-mel kernel: unsupported device {signal.device}")
    if win_length != n_fft:
        raise ValueError("log-mel kernel: win_length must equal n_fft "
                         "(logmel_kernel.py:132 asserts the same)")
    if signal.dtype != torch.float32:
        raise TypeError(f"log-mel kernel: expected float32, got {signal.dtype}")
    if signal.ndim not in (1, 2) or not signal.is_contiguous():
        raise ValueError("log-mel kernel: expected a contiguous [B, S] or [S] waveform")
    squeeze = signal.ndim == 1
    x = signal[None] if squeeze else signal
    B, S = x.shape
    pad = n_fft // 2 if center else 0
    if center and S <= pad:
        raise ValueError(f"log-mel kernel: reflect padding needs more than {pad} samples")
    T = num_frames(S, n_fft, hop_length, center)
    n_freqs = n_fft // 2 + 1
    if T < 1 or n_freqs > 1024:
        raise ValueError(f"log-mel kernel: unsupported shape S={S}, n_fft={n_fft}")

    lib, smem_bytes, launch = _library()
    if smem_bytes(n_fft, hop_length, n_freqs) > 48 * 1024:
        raise ValueError("log-mel kernel: tile does not fit in 48 KB of shared memory")
    wcos, wsin, fb = _kernel_tables(n_fft, n_mels, sample_rate, f_min, f_max, str(x.device))
    out = torch.empty((B, T, n_mels), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = launch(x.data_ptr(), wcos.data_ptr(), wsin.data_ptr(), fb.data_ptr(),
                  out.data_ptr(), B, S, T, n_fft, hop_length, n_freqs, n_mels, pad,
                  log_eps, int(apply_log), stream)
    cuda_build.check_launch(lib, "mmav_logmel", code)
    log_mel_spectrogram_cuda.launches += 1
    return out[0] if squeeze else out


log_mel_spectrogram_cuda.launches = 0
