"""Masked InfoNCE-style contrastive loss on projected frame features.

Mirrors ``multimodal_av_model_tpu/ops/contrastive.py:29-75``: flatten
``[B, T, D]`` over time, L2-normalise, then

* align term (weight 1.0): anchors are overlap frames (mask 1), candidates
  target-solo frames (mask 2); ``-log_softmax(anchor . cand / temperature)``
  averaged over every valid (anchor, candidate) cell;
* suppress term (weight 0.3): the same anchors against other-solo frames
  (mask 0);
* a term with an empty anchor or candidate set is 0.

All ``B*T`` rows stay in one static ``[N, N]`` similarity; invalid columns
are masked to -1e30 inside the softmax and invalid cells left out of the mean.
The JAX code pins that product to full f32 (``Precision.HIGHEST``).  Here it
runs in f64, forward and backward, so no TF32 setting can lower it.
"""

from __future__ import annotations

import torch

from ..data.mixing import MASK_OTHER_SOLO, MASK_OVERLAP, MASK_TARGET_SOLO

_NEG_INF = -1e30


def _masked_term(sim, anchor_mask, cand_mask):
    """Mean over valid (anchor, candidate) cells of ``-log_softmax(sim)``, the
    softmax taken over valid candidates only (``contrastive.py:29-40``)."""
    sim = torch.where(cand_mask[None, :], sim, _NEG_INF)
    neg_logsm = torch.logsumexp(sim, dim=1, keepdim=True) - sim
    cells = anchor_mask[:, None] & cand_mask[None, :]
    count = cells.sum()
    total = torch.where(cells, neg_logsm, 0.0).sum()
    return torch.where(count > 0, total / count.clamp(min=1), 0.0)


def contrastive_loss_with_mask(features: torch.Tensor, mask: torch.Tensor,
                               temperature: float = 0.07, weight_pos_align: float = 1.0,
                               weight_neg_suppress: float = 0.3) -> torch.Tensor:
    """``features [B, T, D]`` (or ``[N, D]``), ``mask`` matching ``[B, T]``
    (or ``[N]``) with codes 0/1/2/3 -> scalar f32 loss."""
    feat = features.float().reshape(-1, features.shape[-1])
    flat_mask = mask.reshape(-1)
    feat = feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True) + 1e-12)
    f64 = feat.double()
    sim = (f64 @ f64.T).float() / temperature
    anchors = flat_mask == MASK_OVERLAP
    pos_loss = _masked_term(sim, anchors, flat_mask == MASK_TARGET_SOLO)
    neg_loss = _masked_term(sim, anchors, flat_mask == MASK_OTHER_SOLO)
    return weight_pos_align * pos_loss + weight_neg_suppress * neg_loss
