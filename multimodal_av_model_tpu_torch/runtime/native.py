"""ctypes bindings of the native host-ops library, with the numpy paths.

Mirrors ``multimodal_av_model_tpu/runtime/native.py:55-67``: ``hostops.cpp``
(a copy of the JAX package's) exposes ``levenshtein_i32``,
``resize_bilinear_f32``, ``pcm16_to_f32``, ``resample_linear_f32`` and
``mix_and_mask_f32``.  It is compiled at first use with ``g++ -O3 -shared
-fPIC`` into ``build/hostops/`` at the repository root (or under
``compile_cache_dir``), named by a hash of its source as the CUDA kernels are
(``ops/cuda_build.py``).

When the build fails the numpy paths (``*_numpy``) run, as in JAX, but not
silently: the compiler's error goes to stderr once and ``have_native()`` says
False.  Where
JAX's pipeline calls the native ops, the port's does too:
``data/pipeline.py:preprocess_lip_clip_host`` (the resize) and
``ops/metrics.py:levenshtein``.  JAX's WAV path (``data/audio_io.py``) calls
neither ``pcm16_to_f32`` nor ``resample_linear``, and the port's does not
either.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

from ..ops import cuda_build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hostops.cpp")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def library_path() -> str:
    return os.path.join(cuda_build.build_dir("hostops"),
                        f"libhostops-{cuda_build.source_digest(SOURCE)}.so")


def build() -> str:
    """Compile the library unless it is built -> its path; raises with the
    compiler's output when the build fails."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"host ops build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"host ops build failed (rc {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C")
    lib.levenshtein_i32.restype = i64
    lib.levenshtein_i32.argtypes = [i32p, i64, i32p, i64]
    lib.resize_bilinear_f32.restype = None
    lib.resize_bilinear_f32.argtypes = [f32p, f32p, i64, i64, i64, i64, i64]
    lib.pcm16_to_f32.restype = None
    lib.pcm16_to_f32.argtypes = [i16p, f32p, i64, i64]
    lib.resample_linear_f32.restype = None
    lib.resample_linear_f32.argtypes = [f32p, i64, f32p, i64, ctypes.c_double, ctypes.c_double]
    lib.mix_and_mask_f32.restype = i64
    lib.mix_and_mask_f32.argtypes = [f32p, i64, f32p, i64, f32p, i32p, i32p]
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _failed
    with _lock:
        if _lib is None and not _failed:
            try:
                _lib = _bind(build())
            except (RuntimeError, OSError) as e:
                _failed = True
                print(f"runtime.native: {e}\nrunning the numpy host ops instead",
                      file=sys.stderr)
        return _lib


def have_native() -> bool:
    """Whether the native library is built and loaded (building it now if
    it was not tried yet)."""
    return _load() is not None


def _codes(seq) -> np.ndarray:
    return np.ascontiguousarray([ord(c) for c in seq] if isinstance(seq, str) else seq,
                                dtype=np.int32)


def levenshtein_numpy(a, b) -> int:
    from ..ops.metrics import levenshtein_py

    return levenshtein_py(_codes(a).tolist(), _codes(b).tolist())


def levenshtein(a, b) -> int:
    """Edit distance between two int sequences (or strings)."""
    lib = _load()
    if lib is None:
        return levenshtein_numpy(a, b)
    a32, b32 = _codes(a), _codes(b)
    return int(lib.levenshtein_i32(a32, len(a32), b32, len(b32)))


def _flat_images(images: np.ndarray):
    images = np.ascontiguousarray(images, dtype=np.float32)
    lead = images.shape[:-2]
    return images.reshape(int(np.prod(lead)) if lead else 1, *images.shape[-2:]), lead


def resize_bilinear_numpy(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    from ..data.pipeline import _resize_bilinear_np

    flat, lead = _flat_images(images)
    return _resize_bilinear_np(flat, out_h, out_w).reshape(*lead, out_h, out_w)


def resize_bilinear(images: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2 INTER_LINEAR resize over the trailing two axes (f32)."""
    lib = _load()
    if lib is None:
        return resize_bilinear_numpy(images, out_h, out_w)
    flat, lead = _flat_images(images)
    out = np.empty((flat.shape[0], out_h, out_w), np.float32)
    lib.resize_bilinear_f32(flat, out, flat.shape[0], flat.shape[1], flat.shape[2], out_h, out_w)
    return out.reshape(*lead, out_h, out_w)


def pcm16_to_f32_numpy(pcm: np.ndarray, channels: int = 1) -> np.ndarray:
    audio = np.asarray(pcm, dtype=np.int16).astype(np.float32) / 32768.0
    if channels > 1:
        audio = audio.reshape(-1, channels).mean(axis=1)
    return audio


def pcm16_to_f32(pcm: np.ndarray, channels: int = 1) -> np.ndarray:
    """16-bit PCM (interleaved channels) -> f32 mono in [-1, 1)."""
    lib = _load()
    if lib is None:
        return pcm16_to_f32_numpy(pcm, channels)
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    frames = len(pcm) // channels
    out = np.empty(frames, np.float32)
    lib.pcm16_to_f32(pcm, out, frames, channels)
    return out


def resample_linear_numpy(audio: np.ndarray, in_rate: float, out_rate: float) -> np.ndarray:
    audio = np.asarray(audio, dtype=np.float32)
    n_out = int(round(len(audio) * out_rate / in_rate))
    idx = np.arange(n_out) * (in_rate / out_rate)
    lo = np.minimum(idx.astype(np.int64), len(audio) - 1)
    hi = np.minimum(lo + 1, len(audio) - 1)
    frac = (idx - lo).astype(np.float32)
    return audio[lo] + (audio[hi] - audio[lo]) * frac


def resample_linear(audio: np.ndarray, in_rate: float, out_rate: float) -> np.ndarray:
    """Linear-interpolation resampling to ``round(len * out / in)`` samples."""
    lib = _load()
    if lib is None:
        return resample_linear_numpy(audio, in_rate, out_rate)
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    n_out = int(round(len(audio) * out_rate / in_rate))
    out = np.empty(n_out, np.float32)
    lib.resample_linear_f32(audio, len(audio), out, n_out, in_rate, out_rate)
    return out


def mix_and_mask_numpy(a1: np.ndarray, a2: np.ndarray):
    from ..data.mixing import mix_pair

    mixed, m1, m2 = mix_pair(np.asarray(a1, np.float32), np.asarray(a2, np.float32))
    return mixed, m1.astype(np.int32), m2.astype(np.int32)


def mix_and_mask(a1: np.ndarray, a2: np.ndarray):
    """Two-speaker mix and masks (``data/mixing.py:mix_pair`` semantics) ->
    ``(mixed, mask1, mask2)``, the masks int32."""
    lib = _load()
    if lib is None:
        return mix_and_mask_numpy(a1, a2)
    a1 = np.ascontiguousarray(a1, dtype=np.float32)
    a2 = np.ascontiguousarray(a2, dtype=np.float32)
    n = max(len(a1), len(a2))
    mixed = np.empty(n, np.float32)
    m1 = np.empty(n, np.int32)
    m2 = np.empty(n, np.int32)
    lib.mix_and_mask_f32(a1, len(a1), a2, len(a2), mixed, m1, m2)
    return mixed, m1, m2
