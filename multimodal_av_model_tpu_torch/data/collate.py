"""Raw batch collation with length bucketing.

Mirrors ``multimodal_av_model_tpu/data/collate.py:26-93``: every batch pads up
to a bucket edge, and the audio and label budgets derive from the video
bucket.  Lip frames keep their source dtype (uint8 crops), so the host-to-device
copy is a quarter of the f32 bytes; the device pipeline reads them as stored.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class BucketSpec:
    video_frames: int
    audio_samples: int
    label_len: int


def make_bucket_specs(video_buckets: Sequence[int], audio_samples_per_video_frame: int = 534,
                      max_label_len: int = 128) -> list[BucketSpec]:
    """One spec per video bucket; the audio budget scales with video length."""
    return [BucketSpec(v, v * audio_samples_per_video_frame, max_label_len)
            for v in video_buckets]


def _pad_to(arr: np.ndarray, length: int) -> np.ndarray:
    """Zero-pad (or truncate) the leading axis to ``length``."""
    arr = np.asarray(arr)
    if arr.shape[0] >= length:
        return arr[:length]
    return np.pad(arr, [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1))


def collate_pairs_raw(samples: list[dict], spec: BucketSpec) -> dict[str, np.ndarray]:
    """Collate raw pair samples (keys ``lip1_raw, lip2_raw, audio1, audio2,
    label1, label2``) for the on-device preprocessing path."""
    B = len(samples)
    Tv, S, L = spec.video_frames, spec.audio_samples, spec.label_len

    def stack(key, length, dtype=None):
        out = np.stack([_pad_to(np.asarray(s[key]), length) for s in samples])
        return out.astype(dtype) if dtype is not None else out

    return {
        "lip1_raw": stack("lip1_raw", Tv),
        "lip2_raw": stack("lip2_raw", Tv),
        "lip1_lengths": np.array([min(s["lip1_raw"].shape[0], Tv) for s in samples], np.int32),
        "lip2_lengths": np.array([min(s["lip2_raw"].shape[0], Tv) for s in samples], np.int32),
        "audio1": stack("audio1", S, dtype=np.float32),
        "audio2": stack("audio2", S, dtype=np.float32),
        "audio1_len": np.array([min(len(s["audio1"]), S) for s in samples], np.int32),
        "audio2_len": np.array([min(len(s["audio2"]), S) for s in samples], np.int32),
        "text1": stack("label1", L, dtype=np.int32),
        "text1_lengths": np.array([min(len(s["label1"]), L) for s in samples], np.int32),
        "text2": stack("label2", L, dtype=np.int32),
        "text2_lengths": np.array([min(len(s["label2"]), L) for s in samples], np.int32),
        "valid": np.ones((B,), np.float32),
    }
