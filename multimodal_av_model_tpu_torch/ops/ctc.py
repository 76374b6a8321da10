"""CTC loss, collapse and greedy decoding on the device.

Mirrors ``multimodal_av_model_tpu/ops/ctc.py:39-185``.  The JAX loss
is a ``lax.scan`` forward recursion, not a Pallas kernel; here it is ATen's
``F.ctc_loss`` (its native kernel: cuDNN's takes blank 0 only).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor, input_lengths: torch.Tensor,
             label_lengths: torch.Tensor, blank_id: int = 0, reduction: str = "mean",
             zero_infinity: bool = True) -> torch.Tensor:
    """CTC negative log-likelihood with the JAX function's semantics.

    ``log_probs [B, T, V]`` log-softmaxed scores (computed in f32),
    ``labels [B, L]`` padded arbitrarily past ``label_lengths [B]``,
    ``input_lengths [B]``.  ``zero_infinity``: an impossible alignment gives
    0.  ``reduction``: "none" (per sample), "sum", or "mean" (per-sample loss
    over its label length, at least 1, then the batch mean).

    The value and the gradient with respect to the logits before a
    ``log_softmax`` are JAX's; the gradient with respect to ``log_probs``
    itself is not (ATen returns ``exp(log_probs) - posterior``, which is the
    true gradient only through a ``log_softmax``).  The CUDA backward adds
    with atomics, so repeats may differ in the last bits.
    """
    per = F.ctc_loss(log_probs.float().transpose(0, 1), labels.long(), input_lengths.long(),
                     label_lengths.long(), blank=blank_id, reduction="none",
                     zero_infinity=zero_infinity)
    if reduction == "none":
        return per
    if reduction == "sum":
        return per.sum()
    if reduction == "mean":
        return (per / label_lengths.clamp(min=1).float()).mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def ctc_loss_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                         input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                         blank_id: int = 0, **kw) -> torch.Tensor:
    """``ctc_loss`` after an f32 ``log_softmax`` of ``logits [B, T, V]``
    (``ctc.py:133-137``).  The ``log_softmax`` is in the graph, so the
    gradient with respect to ``logits`` is the true one (``ctc_loss``'s
    note)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return ctc_loss(log_probs, labels, input_lengths, label_lengths, blank_id, **kw)


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
