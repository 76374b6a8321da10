"""SpecAugment: time and frequency stripes over the log-mel, in train mode.

Mirrors ``multimodal_av_model_tpu/ops/specaugment.py:22-87`` in two parts:

* ``draw_spec_augment``: the stripes' widths and starts from a
  ``torch.Generator`` with JAX's bounds.  A frequency stripe is ``0 ..
  freq_mask_width`` bins wide and starts in ``[0, max(F - width, 1))``; a
  time stripe is at most ``max(valid_len * time_mask_frac, 1)`` frames wide
  (adaptive: short utterances get short stripes) and starts in
  ``[0, max(valid_len - width, 1))``.  The two libraries cannot draw the
  same numbers, so parity is held on the apply, fed JAX's draws;
* ``apply_spec_augment``: the stripes on valid frames only, filled with the
  utterance's mean over its valid frames and bins; padding frames are left
  untouched.  The fill's sum runs in f64 and its quotient is rounded once to
  the features' dtype, so it does not depend on the summation order (the
  card's and the CPU's agree, and on inputs whose f32 sums are exact, JAX's
  too).

Both run on the features' device; nothing goes back to the host.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SpecAugmentDraws:
    """Integer ``[B, masks]`` stripes (a kind that is off has 0 columns)."""

    freq_width: torch.Tensor
    freq_start: torch.Tensor
    time_width: torch.Tensor
    time_start: torch.Tensor


def block_rows(whole: torch.Tensor, rows: tuple[int, int], parts: int = 1) -> torch.Tensor:
    """The rows of ``whole`` (a draw over the whole batch) that block
    ``rows[0]`` of ``rows[1]`` holds, in each of ``parts`` equal parts along
    dim 0, the parts' blocks stacked in order (the placement of these draws
    and of ``models/layers.py:dropout``'s mask)."""
    return whole.unflatten(0, (parts, rows[1], -1))[:, rows[0]].flatten(0, 1)


def draw_spec_augment(generator: torch.Generator, frame_valid: torch.Tensor, n_bins: int,
                      freq_masks: int = 2, freq_mask_width: int = 27, time_masks: int = 2,
                      time_mask_frac: float = 0.05, rows: tuple[int, int] = (0, 1),
                      parts: int = 1) -> SpecAugmentDraws:
    """Stripes for ``frame_valid [B, T]`` (bool) and ``n_bins`` mel bins,
    drawn from ``generator`` (on ``frame_valid``'s device), with the bounds
    of ``specaugment.py:54-76``.

    ``rows`` and ``parts`` place these ``B`` rows in a batch split over a
    mesh, as ``models/layers.py:dropout`` does: every draw is made for the
    whole batch and these rows of it kept, so the ranks draw what one
    device drawing for the whole batch would (``block_rows``)."""
    B = frame_valid.shape[0]
    dev = frame_valid.device
    valid_len = frame_valid.sum(dim=1).clamp(min=1)                       # [B]

    def uniform(m):
        return block_rows(torch.rand(B * rows[1], m, generator=generator, device=dev), rows,
                          parts)

    empty = torch.zeros(B, 0, dtype=torch.int64, device=dev)
    fw = fs = tw = ts = empty
    if freq_masks > 0 and freq_mask_width > 0:
        fw = block_rows(torch.randint(0, freq_mask_width + 1, (B * rows[1], freq_masks),
                                      generator=generator, device=dev), rows, parts)
        fs = (uniform(freq_masks) * (n_bins - fw).clamp(min=1)).long()
    if time_masks > 0 and time_mask_frac > 0:
        max_w = (valid_len.float() * time_mask_frac).clamp(min=1.0)
        tw = (uniform(time_masks) * (max_w[:, None] + 1.0)).long()
        ts = (uniform(time_masks) * (valid_len[:, None] - tw).clamp(min=1)).long()
    return SpecAugmentDraws(fw, fs, tw, ts)


def _stripes(n: int, start: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """``[B, M]`` stripes -> ``[B, n]`` bool, True inside any of them."""
    pos = torch.arange(n, device=start.device)
    hit = (pos >= start[..., None]) & (pos < (start + width)[..., None])   # [B, M, n]
    return hit.any(dim=1)


def apply_spec_augment(mel: torch.Tensor, frame_valid: torch.Tensor | None,
                       draws: SpecAugmentDraws) -> torch.Tensor:
    """``mel [B, T, F]`` with the stripes of ``draws`` set to each
    utterance's valid-frame mean (``specaugment.py:52-87``)."""
    B, T, F = mel.shape
    if frame_valid is None:
        frame_valid = torch.ones(B, T, dtype=torch.bool, device=mel.device)
    valid_len = frame_valid.sum(dim=1).clamp(min=1)
    masked = torch.zeros(B, T, F, dtype=torch.bool, device=mel.device)
    if draws.freq_width.shape[1]:
        masked = masked | _stripes(F, draws.freq_start, draws.freq_width)[:, None, :]
    if draws.time_width.shape[1]:
        masked = masked | _stripes(T, draws.time_start, draws.time_width)[:, :, None]
    masked = masked & frame_valid[..., None]
    total = torch.where(frame_valid[..., None], mel, 0.0).to(torch.float64).sum(dim=(1, 2))
    fill = (total / (valid_len * F).clamp(min=1)).to(mel.dtype)           # [B]
    return torch.where(masked, fill[:, None, None], mel)


def spec_augment(generator: torch.Generator, mel: torch.Tensor,
                 frame_valid: torch.Tensor | None = None, *, freq_masks: int = 2,
                 freq_mask_width: int = 27, time_masks: int = 2,
                 time_mask_frac: float = 0.05, rows: tuple[int, int] = (0, 1),
                 parts: int = 1) -> torch.Tensor:
    """Draw, then apply (``specaugment.py:22-87``); ``rows`` and ``parts``
    as ``draw_spec_augment``'s."""
    if frame_valid is None:
        frame_valid = torch.ones(mel.shape[:2], dtype=torch.bool, device=mel.device)
    draws = draw_spec_augment(generator, frame_valid, mel.shape[2], freq_masks,
                              freq_mask_width, time_masks, time_mask_frac, rows, parts)
    return apply_spec_augment(mel, frame_valid, draws)
