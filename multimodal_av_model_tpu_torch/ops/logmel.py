"""STFT -> log-mel audio frontend: the plain PyTorch version and the wrapper of
its CUDA kernel (K1).

Mirrors ``multimodal_av_model_tpu/ops/logmel.py:34-147`` (filterbank, framing
and the plain ``log_mel_spectrogram``) and
``multimodal_av_model_tpu/ops/pallas/logmel_kernel.py:47-188`` (the fused
kernel, here ``csrc/logmel.cu``).  Semantics are torchaudio's: centred frames
with reflect padding, a periodic Hann window, the rFFT power, an HTK mel
filterbank without normalisation, then ``log(mel + 1e-6)``, all in f32.

``log_mel_spectrogram_cuda`` is the entry the audio encoder calls.  It goes
through the operator ``mmav::log_mel`` (``torch.library.custom_op``) on every
device, so ``torch.export`` keeps K1 as one node: on a CUDA tensor the
operator launches the kernel (or raises), on a CPU tensor it takes the plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build
from .cuda_build import SMEM_LIMIT


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


CLUSTER = 4        # CTAs per cluster = 16-frame m-tiles per cluster
TILE_M = 16        # frames per m-tile; a cluster's 4 m-tiles are the 64 rows of a wgmma
NT_CTA = 14        # 8-column n-tiles per CTA: 2 warpgroups of wgmma N = 56
STAGE_K = 5        # k-steps (of 8) per stage of the basis pipeline (2 slots)
MEL_WIDTH = 16     # a mel filter's support, as the kernel reads it, is a multiple of this
MEL_CHUNKS = 4     # ... of at most 4 (supports of 16, 32, 48 or 64 bins)
THREADS = 256      # threads per CTA: 2 warpgroups
# The same geometry is fixed in csrc/logmel.cu; _check_geometry holds the two equal.


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tf32_round(x: np.ndarray) -> np.ndarray:
    """Round f32 to tf32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` and the K1 kernel's ``tf32_rna``; the 13
    low bits come out zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@functools.lru_cache(maxsize=32)
def logmel_plan(B: int, S: int, n_fft: int = 400, hop_length: int = 160,
                n_mels: int = 80, center: bool = True, sample_rate: int = 16000,
                f_min: float = 0.0, f_max: float | None = None) -> dict:
    """Launch plan of the K1 kernel for a ``[B, S]`` waveform.

    Frames are cut into m-tiles of 16 within each row (``tiles_per_row`` per
    row, global m-tile ``mt`` is row ``mt // tiles_per_row``); a cluster of 4
    CTAs takes m-tiles ``4c..4c+3``, CTA ``r`` of it computes the DFT of those
    4 m-tiles for bins ``r*bins_cta .. (r+1)*bins_cta - 1`` and stores the
    features of m-tile ``4c + r``.

    ``nt_cta`` is the CTA's count of 8-column n-tiles (4 bins each; the
    kernel takes 14, two warpgroups of wgmma N = 56, and ``supported`` says
    whether this n_fft gives that), ``bins`` the padded bin count,
    ``rows_tile`` the hop rows an m-tile's waveform span takes, ``ksteps``
    the basis's count of 8-row k-steps, zero-padded to an even number of
    whole pipeline stages, ``mel_width`` the bins of a mel filter's support
    as the kernel reads it (the widest triangle rounded up to a multiple of
    16: 16 at 80 mels, 48 at 26 mels, n_fft 400), ``mel_fits`` whether the
    kernel has an instance of that width (16 to 64 bins) and every support
    lies inside the padded bins, and ``smem_bytes`` the launch's dynamic
    shared memory: two slots of split basis tiles, the 4 staged spans, the
    ``[16, bins + 4]`` power rows and the filterbank (rows of ``mel_width +
    4`` floats).
    """
    pad = n_fft // 2 if center else 0
    T = num_frames(S, n_fft, hop_length, center)
    n_freqs = n_fft // 2 + 1
    nt_cta = 2 * _cdiv(_cdiv(_cdiv(n_freqs, 4), CLUSTER), 2)
    bins_cta = 4 * nt_cta
    bins = CLUSTER * bins_cta
    tiles_per_row = _cdiv(T, TILE_M)
    n_mtiles = B * tiles_per_row
    rows_tile = TILE_M + (n_fft - 1) // hop_length
    hp, pm_ld = hop_length + 4, bins + 4
    mel_lo, mel_w = mel_support(n_freqs, n_mels, sample_rate, f_min, f_max)
    mel_width = mel_w.shape[1]
    floats = (2 * STAGE_K * 16 * nt_cta * 8 + CLUSTER * rows_tile * hp
              + TILE_M * pm_ld + n_mels * (mel_width + 4) + n_mels)
    return {"T": T, "pad": pad, "n_freqs": n_freqs, "nt_cta": nt_cta,
            "mel_width": mel_width,
            "mel_fits": (mel_width <= MEL_CHUNKS * MEL_WIDTH
                         and bool((mel_lo + mel_width <= bins).all())),
            "bins_cta": bins_cta, "bins": bins, "tiles_per_row": tiles_per_row,
            "n_mtiles": n_mtiles, "ctas": CLUSTER * _cdiv(n_mtiles, CLUSTER),
            "threads": THREADS, "rows_tile": rows_tile, "supported": nt_cta == NT_CTA,
            "ksteps": 2 * STAGE_K * _cdiv(n_fft // 8, 2 * STAGE_K),
            "smem_bytes": 4 * floats}


def logmel_cta_frames(plan: dict, cta: int):
    """``(row, first frame, end frame)`` whose features CTA ``cta`` stores, or
    None.  CTA ``r`` of cluster ``c`` stores m-tile ``4c + r``, which is the
    CTA's own index (``csrc/logmel.cu`` step 5)."""
    if cta >= plan["n_mtiles"]:
        return None
    b, tile = divmod(cta, plan["tiles_per_row"])
    t0 = tile * TILE_M
    return b, t0, min(t0 + TILE_M, plan["T"])


def basis_tiles(mat: np.ndarray, nt_cta: int = NT_CTA) -> np.ndarray:
    """Lay out a ``[K, N]`` f32 basis (K a multiple of 8, N of ``8 * nt_cta``)
    in the order of the kernel's shared-memory tiles: ``[N / (8 nt_cta)
    ranks, K/8 k-steps, nt_cta groups, 2 k-cores, 8 n, 4 k]``.  Element
    ``mat[8 ks + 4 kc + kk, 8 nt_cta r + 8 gi + n]`` sits at ``[r, ks, gi,
    kc, n, kk]``: each 8 x 4 core matrix is 128 contiguous bytes (the K-major
    layout without swizzle that wgmma reads), and rank ``r``'s k-step is one
    contiguous 3.5 KB run.  The kernel splits each value into tf32 hi and lo
    (``tf32_round``) as it copies the run into shared memory."""
    mat = np.asarray(mat, np.float32)
    K, N = mat.shape
    t = mat.reshape(K // 8, 2, 4, N // (8 * nt_cta), nt_cta, 8)   # ks, kc, kk, r, gi, n
    return np.ascontiguousarray(t.transpose(3, 0, 4, 1, 5, 2))


def dft_matrix(n_fft: int, bins: int, rows: int | None = None) -> np.ndarray:
    """The kernel's windowed DFT basis before the split, ``[rows, 2*bins]``
    f32: re and im of bin f in columns 2f, 2f+1, zero past the
    ``n_fft // 2 + 1`` real bins and past row ``n_fft``
    (``logmel_kernel.py:47-59,155-162``)."""
    n_freqs = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(n_freqs)) / n_fft
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    dft = np.zeros((rows or n_fft, 2 * bins), np.float32)
    dft[:n_fft, 0:2 * n_freqs:2] = window[:, None] * np.cos(ang).astype(np.float32)
    dft[:n_fft, 1:2 * n_freqs:2] = window[:, None] * -np.sin(ang).astype(np.float32)
    return dft


@functools.lru_cache(maxsize=8)
def mel_support(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                f_max: float | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank as the kernel reads it: filter m's first bin ``lo[m]``
    (int32) and its weights ``w[m, :]`` over the next ``width`` bins (f32,
    zero past its support), ``width`` being the widest triangle rounded up to
    a multiple of ``MEL_WIDTH`` (16): the kernel reads supports of 16 to 64
    bins."""
    fb = mel_filterbank(n_freqs, n_mels, sample_rate, f_min, f_max)
    nz = [np.flatnonzero(fb[:, m]) for m in range(n_mels)]
    lo = np.array([z[0] if len(z) else 0 for z in nz], np.int32)
    widest = max(1, max(int(z[-1] - z[0] + 1) if len(z) else 0 for z in nz))
    width = MEL_WIDTH * _cdiv(widest, MEL_WIDTH)
    w = np.zeros((n_mels, width), np.float32)
    for m, z in enumerate(nz):
        if len(z):
            w[m, :z[-1] - z[0] + 1] = fb[z[0]:z[-1] + 1, m]
    return lo, w


@functools.lru_cache(maxsize=8)
def _kernel_tables(n_fft: int, n_mels: int, sample_rate: int, f_min: float,
                   f_max: float | None, bins: int, ksteps: int, device: str):
    """The DFT basis in tile order and the filterbank supports, on
    ``device``."""
    lo, w = mel_support(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (basis_tiles(dft_matrix(n_fft, bins, 8 * ksteps)), lo, w))


def _check_geometry(lib) -> None:
    """Raise if the kernel's geometry is not the one ``logmel_plan`` lays out
    (the launch itself refuses a shared-memory size other than its own)."""
    geometry = (ctypes.c_int * 6)()
    lib.mmav_logmel_geometry(geometry)
    expected = (CLUSTER, TILE_M, NT_CTA, STAGE_K, MEL_WIDTH, THREADS)
    if tuple(geometry) != expected:
        raise RuntimeError(f"log-mel kernel: csrc/logmel.cu has geometry {tuple(geometry)}, "
                           f"logmel_plan assumes {expected}")


_launch = cuda_build.Launcher(
    "logmel", "mmav_logmel",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_float] + [ctypes.c_int] * 3,
    on_load=_check_geometry)


def _log_mel_launch(signal: torch.Tensor, sample_rate: int, n_fft: int, hop_length: int,
                    win_length: int, n_mels: int, f_min: float, f_max: float | None,
                    log_eps: float, center: bool, apply_log: bool) -> torch.Tensor:
    """The ``"cuda"`` kernel of ``mmav::log_mel``: launches ``csrc/logmel.cu``
    on a ``[B, S]`` waveform and counts one launch in
    ``log_mel_spectrogram_cuda.launches``.  Raises on anything the kernel
    does not take."""
    if win_length != n_fft:
        raise ValueError("log-mel kernel: win_length must equal n_fft "
                         "(logmel_kernel.py:132 asserts the same)")
    if signal.dtype != torch.float32:
        raise TypeError(f"log-mel kernel: expected float32, got {signal.dtype}")
    if not signal.is_contiguous():
        raise ValueError("log-mel kernel: expected a contiguous [B, S] or [S] waveform")
    if n_fft % 8 or hop_length % 8:
        raise ValueError("log-mel kernel: n_fft and hop_length must be multiples of 8 "
                         "(the wgmma k step)")
    B, S = signal.shape
    if center and S <= n_fft // 2:
        raise ValueError(f"log-mel kernel: reflect padding needs more than "
                         f"{n_fft // 2} samples")
    plan = logmel_plan(B, S, n_fft, hop_length, n_mels, center, sample_rate, f_min, f_max)
    if plan["T"] < 1:
        raise ValueError(f"log-mel kernel: no frame in S={S} samples")
    if not plan["supported"] or plan["smem_bytes"] > SMEM_LIMIT or not plan["mel_fits"]:
        raise ValueError(f"log-mel kernel: n_fft={n_fft}, n_mels={n_mels} give "
                         f"{plan['nt_cta']} n-tiles per CTA (the kernel takes {NT_CTA}), need "
                         f"{plan['smem_bytes']} bytes of shared memory (at most {SMEM_LIMIT}), "
                         f"and mel supports of {plan['mel_width']} bins (at most "
                         f"{MEL_CHUNKS * MEL_WIDTH}) inside the padded bins: {plan['mel_fits']}")

    basis, mel_lo, mel_w = _kernel_tables(n_fft, n_mels, sample_rate, f_min, f_max,
                                          plan["bins"], plan["ksteps"], str(signal.device))
    out = torch.empty((B, plan["T"], n_mels), dtype=torch.float32, device=signal.device)
    _launch(signal.device, log_mel_spectrogram_cuda, signal.data_ptr(), basis.data_ptr(),
            mel_lo.data_ptr(), mel_w.data_ptr(), out.data_ptr(), S, plan["T"], n_fft, hop_length,
            plan["pad"], plan["tiles_per_row"], plan["n_mtiles"], plan["rows_tile"], n_mels,
            plan["ksteps"], plan["mel_width"], log_eps, int(apply_log), plan["ctas"],
            plan["smem_bytes"])
    return out


# K1 as an operator, so that torch.export traces it as one node: the CUDA
# kernel on the card, the plain version on the CPU, and a fake that gives the
# output's shape.  No autograd: the waveform is data and the features are
# detached (JAX puts K1 under stop_gradient, models/audio.py:147).
log_mel_op = torch.library.custom_op(
    "mmav::log_mel", _log_mel_launch, mutates_args=(), device_types="cuda",
    schema="(Tensor signal, int sample_rate, int n_fft, int hop_length, int win_length, "
           "int n_mels, float f_min, float? f_max, float log_eps, bool center, "
           "bool apply_log) -> Tensor")


@log_mel_op.register_kernel("cpu")
def _log_mel_plain(signal, sample_rate, n_fft, hop_length, win_length, n_mels, f_min, f_max,
                   log_eps, center, apply_log):
    return log_mel_spectrogram(signal, sample_rate, n_fft, hop_length, win_length, n_mels,
                               f_min, f_max, log_eps, center, apply_log)


@log_mel_op.register_fake
def _log_mel_fake(signal, sample_rate, n_fft, hop_length, win_length, n_mels, f_min, f_max,
                  log_eps, center, apply_log):
    B, S = signal.shape
    return signal.new_empty((B, num_frames(S, n_fft, hop_length, center), n_mels),
                            dtype=torch.float32)


def log_mel_spectrogram_cuda(signal: torch.Tensor, sample_rate: int = 16000,
                             n_fft: int = 400, hop_length: int = 160,
                             win_length: int | None = None, n_mels: int = 80,
                             f_min: float = 0.0, f_max: float | None = None,
                             log_eps: float = 1e-6, center: bool = True,
                             apply_log: bool = True) -> torch.Tensor:
    """K1: fused log-mel of a ``[B, S]`` (or ``[S]``) f32 waveform, through
    the operator ``mmav::log_mel`` on every device.

    A CUDA tensor launches ``csrc/logmel.cu`` (counted in
    ``log_mel_spectrogram_cuda.launches`` when it runs, in an exported
    program too) or raises; a CPU tensor takes the plain
    ``log_mel_spectrogram``.  The operator returns a fresh ``[B, T, n_mels]``;
    a 1-D input's batch axis is dropped here, outside it.
    """
    if signal.device.type not in ("cpu", "cuda"):
        raise ValueError(f"log-mel kernel: unsupported device {signal.device}")
    if signal.ndim not in (1, 2):
        raise ValueError("log-mel kernel: expected a contiguous [B, S] or [S] waveform")
    squeeze = signal.ndim == 1
    out = log_mel_op(signal[None] if squeeze else signal, sample_rate, n_fft, hop_length,
                     win_length or n_fft, n_mels, float(f_min),
                     None if f_max is None else float(f_max), float(log_eps), bool(center),
                     bool(apply_log))
    return out[0] if squeeze else out


log_mel_spectrogram_cuda.launches = 0
