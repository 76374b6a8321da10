"""Host-side WAV decode, 48 -> 16 kHz resampling and the decoded-file cache.

Own copy of ``multimodal_av_model_tpu/data/audio_io.py:29-161``:

* ``read_wav`` decodes PCM with the stdlib ``wave`` module and float WAVs
  (format 3, and the extensible variants) with a minimal RIFF parser, to f32
  mono in [-1, 1] (channels averaged, as ``librosa.load(mono=True)``);
* ``resample`` is ``scipy.signal.resample_poly`` in f32;
* ``WavCache`` keeps decoded, resampled source files (LRU), so a sentence
  costs a slice ``a[int(t0 * sr):int(t1 * sr)]``, not a decode;
* ``write_wav`` writes 16-bit PCM, mono ``[S]`` or interleaved ``[S, C]``.
"""

from __future__ import annotations

import math
import struct
import wave
from collections import OrderedDict

import numpy as np


def _parse_wav_manual(path: str) -> tuple[int, int, int, int, bytes]:
    """RIFF parser for what ``wave`` rejects -> ``(format_code, n_channels,
    sample_rate, bits_per_sample, data)``."""
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = data = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            cid, size = struct.unpack("<4sI", head)
            chunk = f.read(size)
            if size % 2:
                f.read(1)                       # chunks are word-aligned
            if cid == b"fmt ":
                fmt = chunk
            elif cid == b"data":
                data = chunk
    if fmt is None or data is None or len(fmt) < 16:
        raise ValueError(f"missing fmt/data chunk in {path}")
    code, n_channels, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if code == 0xFFFE and len(fmt) >= 26:       # WAVE_FORMAT_EXTENSIBLE: the sub-format
        code = struct.unpack("<H", fmt[24:26])[0]
    return code, n_channels, sr, bits, data


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a PCM or float WAV to f32 mono in [-1, 1] -> ``(audio, sr)``."""
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n_channels = w.getnchannels()
            sampwidth = w.getsampwidth()
            raw = w.readframes(w.getnframes())
        fmt_code = 1                            # wave takes PCM only
    except wave.Error:
        fmt_code, n_channels, sr, bits, raw = _parse_wav_manual(path)
        sampwidth = bits // 8
    if fmt_code == 3:
        if sampwidth == 4:
            audio = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif sampwidth == 8:
            audio = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float sample width {sampwidth} in {path}")
    elif fmt_code != 1:
        raise ValueError(f"unsupported WAV format code {fmt_code} in {path}")
    elif sampwidth == 2:
        audio = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        audio = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val & 0x800000, val - 0x1000000, val)
        audio = val.astype(np.float32) / 8388608.0
    elif sampwidth == 1:
        audio = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sampwidth} in {path}")
    if n_channels > 1:
        audio = audio.reshape(-1, n_channels).mean(axis=1)
    return audio, sr


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling in f32."""
    if orig_sr == target_sr:
        return np.asarray(audio, np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    out = resample_poly(np.asarray(audio, np.float32), target_sr // g, orig_sr // g)
    return out.astype(np.float32)


def load_audio(path: str, target_sr: int = 16000) -> np.ndarray:
    audio, sr = read_wav(path)
    return resample(audio, sr, target_sr)


class WavCache:
    """LRU cache of decoded, resampled source files keyed by path."""

    def __init__(self, target_sr: int = 16000, max_items: int = 32):
        self.target_sr = target_sr
        self.max_items = max_items
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()

    def load(self, path: str) -> np.ndarray:
        if path in self._cache:
            self._cache.move_to_end(path)
            return self._cache[path]
        audio = load_audio(path, self.target_sr)
        self._cache[path] = audio
        if len(self._cache) > self.max_items:
            self._cache.popitem(last=False)
        return audio

    def load_segment(self, path: str, start_time: float, end_time: float) -> np.ndarray:
        """The ``target_sr`` slice from ``start_time`` to ``end_time`` seconds."""
        audio = self.load(path)
        sr = self.target_sr
        return audio[int(start_time * sr): int(end_time * sr)]


def write_wav(path: str, audio: np.ndarray, sr: int = 16000) -> None:
    """16-bit PCM writer: mono ``[S]`` or ``[S, C]`` interleaved frames."""
    pcm = np.clip(np.asarray(audio, np.float64), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    n_channels = 1 if pcm.ndim == 1 else int(pcm.shape[1])
    with wave.open(path, "wb") as w:
        w.setnchannels(n_channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
