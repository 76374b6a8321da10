"""The reference's frame-synchronous path beam, batched over utterances.

Mirrors ``multimodal_av_model_tpu/ops/beam_search.py:37-102``
(``decode.algorithm="reference_beam"``).  Beams are *un-collapsed frame
paths* in a ``[W, T]`` token buffer; each frame extends every beam with each
of the frame's top-``W`` tokens (``W*W`` candidates), merges identical paths
as a dict would (the slot of the first occurrence, the value of the group's
maximum), and keeps the best ``W`` by a stable sort (ties keep the earlier
candidate).  Frames past an utterance's length extend every beam with a
score-0 blank, which the final collapse removes.  Only the best path is
collapsed (repeats, then blanks).

The JAX version scans one utterance and ``vmap``s; here a Python loop over
frames runs every utterance of the batch at once.  The top-``W`` tokens come
from a stable descending sort (lower token id first on equal scores, as
``lax.top_k``).
"""

from __future__ import annotations

import torch

from .ctc import ctc_collapse

_NEG_INF = -1e30


def beam_search_decode(log_probs: torch.Tensor, lengths: torch.Tensor, beam_width: int = 5,
                       blank_id: int = 3, pad_id: int = -1):
    """``log_probs [B, T, V]`` log-softmaxed, ``lengths [B]`` -> ``(ids [B, T]
    collapsed and padded with pad_id, out_lengths [B] int32, scores [B])``;
    the score is the best path's, before the collapse."""
    lp = log_probs.to(torch.float32)
    B, T, V = lp.shape
    W = beam_width
    WK = W * W
    dev = lp.device
    t_idx = torch.arange(T, device=dev)
    blank_row = torch.full((V,), _NEG_INF, device=dev)
    blank_row[blank_id] = 0.0
    lp = torch.where((t_idx[None, :] < lengths.to(dev)[:, None])[..., None], lp, blank_row)
    top_vals, top_ids = torch.sort(lp, dim=-1, descending=True, stable=True)
    top_vals, top_ids = top_vals[..., :W], top_ids[..., :W].to(torch.int32)

    seqs = torch.full((B, W, T), -1, dtype=torch.int32, device=dev)
    scores = torch.full((B, W), _NEG_INF, device=dev)
    scores[:, 0] = 0.0
    parent = torch.arange(W, device=dev).repeat_interleave(W)         # [WK]
    idx = torch.arange(WK, device=dev)
    earlier = idx[None, :] < idx[:, None]                             # [j, i]: i before j
    for t in range(T):
        cand_scores = (scores[:, :, None] + top_vals[:, t, None, :]).reshape(B, WK)
        cand_seqs = seqs[:, parent].clone()                           # [B, WK, T]
        cand_seqs[:, :, t] = top_ids[:, t].repeat(1, W)
        eq = (cand_seqs[:, :, None, :] == cand_seqs[:, None, :, :]).all(dim=-1)
        is_first = ~(eq & earlier).any(dim=-1)
        group_max = torch.where(eq, cand_scores[:, None, :], _NEG_INF).amax(dim=-1)
        merged = torch.where(is_first, group_max, _NEG_INF)
        order = torch.argsort(-merged, dim=1, stable=True)[:, :W]
        seqs = cand_seqs.gather(1, order[..., None].expand(B, W, T))
        scores = merged.gather(1, order)
    ids, out_len = ctc_collapse(seqs[:, 0], torch.full((B,), T, device=dev), blank_id, pad_id)
    return ids, out_len, scores[:, 0]
