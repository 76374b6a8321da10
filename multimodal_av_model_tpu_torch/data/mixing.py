"""Two-speaker waveform mixing and per-speaker sample masks.

Mirrors ``multimodal_av_model_tpu/data/mixing.py:21-105``: one pair on the
host (numpy, ``mix_pair``), a padded batch on the device
(``mix_pair_batched_device``), and a mask resampled to a frame rate on the
host (``downsample_mask_nearest``).  Both utterances are summed and
peak-normalised by ``max|mixed| + 1e-6``; each speaker's mask codes ``0``
other speaker solo, ``1`` overlap, ``2`` target speaker solo, ``3`` batch
padding.
"""

from __future__ import annotations

import numpy as np
import torch

MASK_OTHER_SOLO = 0
MASK_OVERLAP = 1
MASK_TARGET_SOLO = 2
MASK_PAD = 3


def make_speaker_masks(len1: int, len2: int) -> tuple[np.ndarray, np.ndarray]:
    """Masks over ``max(len1, len2)`` samples for each speaker."""
    max_len, min_len = max(len1, len2), min(len1, len2)
    mask1 = np.zeros(max_len, dtype=np.int64)
    mask2 = np.zeros(max_len, dtype=np.int64)
    mask1[:min_len] = MASK_OVERLAP
    mask2[:min_len] = MASK_OVERLAP
    if len1 > len2:
        mask1[len2:len1] = MASK_TARGET_SOLO
    elif len2 > len1:
        mask2[len1:len2] = MASK_TARGET_SOLO
    return mask1, mask2


def mix_pair(a1: np.ndarray, a2: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mix two mono waveforms of any lengths -> ``(mixed, mask1, mask2)``,
    each ``max(len(a1), len(a2))`` long."""
    len1, len2 = len(a1), len(a2)
    max_len = max(len1, len2)
    mixed = (np.pad(np.asarray(a1, dtype=np.float32), (0, max_len - len1))
             + np.pad(np.asarray(a2, dtype=np.float32), (0, max_len - len2)))
    mixed /= np.max(np.abs(mixed)) + 1e-6
    mask1, mask2 = make_speaker_masks(len1, len2)
    return mixed.astype(np.float32), mask1, mask2


def mix_pair_batched_device(audio1: torch.Tensor, audio2: torch.Tensor,
                            len1: torch.Tensor, len2: torch.Tensor):
    """Batched mixing of pre-padded inputs.

    Args:
      audio1, audio2: ``[B, S]`` float32, zero-padded past their lengths.
      len1, len2: ``[B]`` true sample counts.

    Returns ``(mixed [B,S] f32, mask1 [B,S] int32, mask2 [B,S] int32,
    mix_len [B] int32)``; positions past ``max(len1, len2)`` are ``MASK_PAD``.
    """
    audio1 = audio1.to(torch.float32)
    audio2 = audio2.to(torch.float32)
    len1 = len1.to(torch.int32)[:, None]
    len2 = len2.to(torch.int32)[:, None]
    S = audio1.shape[-1]
    pos = torch.arange(S, dtype=torch.int32, device=audio1.device)[None, :]

    in1 = pos < len1
    in2 = pos < len2
    zero = audio1.new_zeros(())
    mixed = torch.where(in1, audio1, zero) + torch.where(in2, audio2, zero)
    peak = mixed.abs().amax(dim=-1, keepdim=True) + 1e-6
    mixed = mixed / peak

    overlap = in1 & in2

    def code(inside):
        solo = torch.where(inside, MASK_TARGET_SOLO, MASK_OTHER_SOLO)
        return torch.where(overlap, MASK_OVERLAP, solo)

    mix_len = torch.maximum(len1, len2)
    pad = pos >= mix_len
    mask1 = torch.where(pad, MASK_PAD, code(in1)).to(torch.int32)
    mask2 = torch.where(pad, MASK_PAD, code(in2)).to(torch.int32)
    return mixed, mask1, mask2, mix_len[:, 0]


def downsample_mask_nearest(mask: np.ndarray, target_len: int) -> np.ndarray:
    """Nearest-neighbour resampling of the last axis to ``target_len``
    (``mixing.py:93-105``, as ``F.interpolate(mode="nearest")``): output
    ``j`` reads input ``floor(j * (S / target_len))``, computed in float64
    as JAX does (``models/av_model.py:downsample_mask_to`` uses integer
    math instead), clipped to ``S - 1``."""
    mask = np.asarray(mask)
    S = mask.shape[-1]
    idx = np.floor(np.arange(target_len) * (S / target_len)).astype(np.int64)
    return mask[..., np.minimum(idx, S - 1)]
