"""CTC collapse and greedy decoding on the device.

Mirrors ``multimodal_av_model_tpu/ops/ctc.py:140-185``.  The CTC loss belongs
to the training slice and is not ported yet.
"""

from __future__ import annotations

import torch


def ctc_collapse(ids: torch.Tensor, lengths: torch.Tensor, blank_id: int, pad_id: int = -1):
    """Batched CTC collapse: drop repeats, then blanks.

    ``ids [B, T]``, ``lengths [B]`` -> ``(collapsed [B, T] padded with pad_id,
    out_lengths [B] int32)``.
    """
    ids = ids.to(torch.int32)
    B, T = ids.shape
    prev = torch.cat([ids.new_full((B, 1), -1), ids[:, :-1]], dim=1)
    pos = torch.arange(T, device=ids.device)[None, :]
    keep = (ids != prev) & (ids != blank_id) & (pos < lengths.to(ids.device)[:, None])
    new_pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    scatter_idx = torch.where(keep, new_pos, T)                   # T -> dropped
    out = ids.new_full((B, T + 1), pad_id)
    out.scatter_(1, scatter_idx, torch.where(keep, ids, pad_id))
    return out[:, :T], keep.sum(dim=1).to(torch.int32)


def ctc_greedy_decode(log_probs: torch.Tensor, lengths: torch.Tensor, blank_id: int,
                      pad_id: int = -1):
    """Best-path decode: per-frame argmax (first maximum on ties) + collapse."""
    return ctc_collapse(log_probs.argmax(dim=-1), lengths, blank_id, pad_id)
