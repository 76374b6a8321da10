"""Batch collation with length bucketing.

Mirrors ``multimodal_av_model_tpu/data/collate.py:26-125``: every batch pads
up to a bucket edge, and the audio and label budgets derive from the video
bucket.  Two layouts: ``collate_pairs_raw`` for the on-device preprocessing
path, whose lip frames keep their source dtype (uint8 crops, a quarter of the
f32 bytes to copy to the device), and ``collate_pairs``, the model's own
layout (f32 lips, the mixture and its masks, padded with ``MASK_PAD``) for
pairs preprocessed on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .mixing import MASK_PAD


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


def pick_bucket(specs: Sequence[BucketSpec], video_len: int, audio_len: int) -> BucketSpec:
    """The first bucket that holds both lengths, else the last (which truncates)."""
    for spec in specs:
        if video_len <= spec.video_frames and audio_len <= spec.audio_samples:
            return spec
    return specs[-1]


def _pad_to(arr: np.ndarray, length: int, value=0) -> np.ndarray:
    """Pad with ``value`` (or truncate) the leading axis to ``length``."""
    arr = np.asarray(arr)
    if arr.shape[0] >= length:
        return arr[:length]
    return np.pad(arr, [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1),
                  constant_values=value)


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


def collate_pairs(samples: list[dict], spec: BucketSpec) -> dict[str, np.ndarray]:
    """Collate host-preprocessed pair samples (keys ``lip1, lip2, audio,
    mask1, mask2, label1, label2``) into the model's batch layout."""
    B = len(samples)
    Tv, S, L = spec.video_frames, spec.audio_samples, spec.label_len

    def stack(key, length, value=0, dtype=None):
        out = np.stack([_pad_to(np.asarray(s[key]), length, value) for s in samples])
        return out.astype(dtype) if dtype is not None else out

    return {
        "lip1": stack("lip1", Tv, dtype=np.float32),
        "lip1_lengths": np.array([min(s["lip1"].shape[0], Tv) for s in samples], np.int32),
        "text1": stack("label1", L, dtype=np.int32),
        "text1_lengths": np.array([min(len(s["label1"]), L) for s in samples], np.int32),
        "lip2": stack("lip2", Tv, dtype=np.float32),
        "lip2_lengths": np.array([min(s["lip2"].shape[0], Tv) for s in samples], np.int32),
        "text2": stack("label2", L, dtype=np.int32),
        "text2_lengths": np.array([min(len(s["label2"]), L) for s in samples], np.int32),
        "audio": stack("audio", S, dtype=np.float32),
        "audio_lengths": np.array([min(len(s["audio"]), S) for s in samples], np.int32),
        "mask1": stack("mask1", S, value=MASK_PAD, dtype=np.int32),
        "mask2": stack("mask2", S, value=MASK_PAD, dtype=np.int32),
        "valid": np.ones((B,), np.float32),
    }
