"""The self-supervised objective of the SSL family: masked-span InfoNCE.

Mirrors ``multimodal_av_model_tpu/ops/ssl.py:24-81``:

* ``make_span_mask`` is the port's own copy of the numpy span sampler: for
  the same ``np.random.Generator`` state it draws the same numbers in the
  same order, so its masks equal JAX's byte for byte;
* ``masked_infonce_loss``: for each masked valid frame, a cosine-similarity
  softmax (over the temperature) against every masked valid frame of the
  same sample, the frame itself being the true class; the mean NLL over
  masked frames, in f32.  Columns outside the candidates get -1e30, not
  -inf, so a sample with no masked frame stays finite (its row is uniform
  and weighted out).
"""

from __future__ import annotations

import numpy as np
import torch


def make_span_mask(batch: int, length: int, mask_prob: float = 0.065, span: int = 10,
                   rng: np.random.Generator | None = None, min_masked: int = 2) -> np.ndarray:
    """``[batch, length]`` bool: each position starts a ``span``-long mask
    with probability ``mask_prob``, at least ``min_masked`` starts per row
    (``ssl.py:24-43``)."""
    rng = rng or np.random.default_rng()
    starts = rng.random((batch, length)) < mask_prob
    for b in range(batch):
        n = int(starts[b].sum())
        if n < min_masked:
            idx = rng.choice(length, size=min_masked - n, replace=False)
            starts[b, idx] = True
    mask = np.zeros((batch, length), bool)
    for offset in range(min(span, length)):        # spans clip at the end
        end = length - offset if offset else length
        mask[:, offset:] |= starts[:, :end]
    return mask


def masked_infonce_loss(predictions: torch.Tensor, targets: torch.Tensor,
                        mask_spans: torch.Tensor, frame_valid: torch.Tensor,
                        temperature: float = 0.1) -> torch.Tensor:
    """``predictions``, ``targets [B, T, D]``; ``mask_spans``,
    ``frame_valid [B, T]`` bool -> the scalar loss (``ssl.py:46-81``)."""
    preds = predictions.to(torch.float32)
    tgts = targets.to(torch.float32)
    preds = preds / torch.linalg.vector_norm(preds, dim=-1, keepdim=True).clamp(min=1e-6)
    tgts = tgts / torch.linalg.vector_norm(tgts, dim=-1, keepdim=True).clamp(min=1e-6)
    active = mask_spans & frame_valid                                  # [B, T]
    sim = torch.einsum("btd,bsd->bts", preds, tgts) / temperature      # [B, T, T]
    sim = torch.where(active[:, None, :], sim, -1e30)                  # candidate columns
    diag = torch.log_softmax(sim, dim=-1).diagonal(dim1=1, dim2=2)     # [B, T]
    per_pos = torch.where(active, -diag, 0.0)
    return per_pos.sum() / active.sum().clamp(min=1)
