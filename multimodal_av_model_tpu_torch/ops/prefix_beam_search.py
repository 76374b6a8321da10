"""CTC prefix beam search on the device, batched over utterances.

Mirrors ``multimodal_av_model_tpu/ops/prefix_beam_search.py:41-251``: the
offline decode and the streaming continuation (``prefix_beam_state_init``,
``prefix_beam_stream_step``, ``:161-212``) share one per-frame step.  Beams
are collapsed label prefixes carrying two log-masses, ``p_b`` (alignments
ending in blank) and ``p_nb`` (ending in the prefix's last label), recursed
per frame:

  stay     p_b'(A)    += (p_b(A) + p_nb(A)) * P(blank)
  repeat   p_nb'(A)   += p_nb(A) * P(l)             l = last label of A
  split    p_nb'(A+l) += p_b(A) * P(l)
  extend   p_nb'(A+c) += (p_b(A) + p_nb(A)) * P(c)  c != l

Prefixes live in a ``[W, C]`` buffer padded with -1, so content equality is
prefix equality (``C = T`` offline; when streaming, the stream's capacity,
independent of its chunks' length); each frame proposes ``W*(K+1)``
candidates (one stay plus the frame's top-K tokens per beam), merges
duplicates into the first occurrence by log-sum-exp, and keeps the best
``W``.  Frames past an utterance's length leave its state alone.  The JAX
version scans one utterance and ``vmap``s; here a Python loop over frames
runs every utterance of the batch at once.

Tie order is explicit, as in JAX: the top-K tokens come from a stable
descending sort (lower token id first on equal scores, as ``lax.top_k``), and
the beam ranking is a stable argsort (lower candidate index first).
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _logaddexp(a, b):
    """log(e^a + e^b), safe at the -inf sentinel."""
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=_NEG_INF / 2)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(m <= _NEG_INF / 2, _NEG_INF, out)


def _group_logsumexp(eq, vals):
    """Per-row masked log-sum-exp of ``vals [N, M]`` over each row's group
    ``eq [N, M, M]``."""
    masked = torch.where(eq, vals[:, None, :], _NEG_INF)
    m = masked.amax(dim=-1)
    m_safe = torch.clamp(m, min=_NEG_INF / 2)
    s = m_safe + torch.log(torch.exp(masked - m_safe[..., None]).sum(dim=-1))
    return torch.where(m <= _NEG_INF / 2, _NEG_INF, s)


def _make_step(B: int, W: int, C: int, K: int, V: int, blank_id: int, device,
               lm=None, lm_weight: float = 0.0, length_bonus: float = 0.0):
    """The per-frame recursion over a batch of ``[W, C]`` prefix buffers
    (``prefix_beam_search.py:57-158``): ``step(state, lp [B, V], top_vals
    [B, K], top_ids [B, K], keep [B]) -> state``; rows where ``keep`` is
    False (frames past their length) are left as they were."""
    M = W * (K + 1)
    cols = torch.arange(C, device=device)
    idx = torch.arange(M, device=device)
    earlier = idx[None, :] < idx[:, None]                     # [M, M]: j before i
    neg_wk = torch.full((B, W, K), _NEG_INF, device=device)

    def step(state, lp, top_vals, top_ids, keep):
        prefixes, lens, pb, pnb = state
        total = _logaddexp(pb, pnb)                                # [B, W]
        last = prefixes.gather(2, (lens - 1).clamp(min=0)[..., None])[..., 0]   # [B, W]
        has_last = lens > 0
        lp_last = torch.where(has_last, lp.gather(1, last.clamp(min=0).to(torch.int64)),
                              _NEG_INF)

        stay_pb = total + lp[:, blank_id:blank_id + 1]
        stay_pnb = pnb + lp_last

        c = top_ids[:, None, :].expand(B, W, K)                    # [B, W, K]
        pc = top_vals[:, None, :].expand(B, W, K)
        is_blank = c == blank_id
        same = (c == last[..., None]) & has_last[..., None]
        base = torch.where(same, pb[..., None], total[..., None])  # split vs extend
        ext_pnb = torch.where(is_blank, _NEG_INF, base + pc)
        if lm is not None:
            ctx = torch.where(has_last, last, V).to(torch.int64)  # BOS = V
            lm_bonus = lm_weight * lm[ctx[..., None], c.to(torch.int64)] + length_bonus
            ext_pnb = torch.where(is_blank, _NEG_INF, ext_pnb + lm_bonus)
        at_end = cols[None, None, :] == lens[..., None]            # [B, W, C]
        ext_prefixes = torch.where(at_end[:, :, None, :], c[..., None],
                                   prefixes[:, :, None, :])        # [B, W, K, C]
        full = lens >= C
        ext_pnb = torch.where(full[..., None], _NEG_INF, ext_pnb)

        cand_prefixes = torch.cat([prefixes[:, :, None], ext_prefixes], 2).reshape(B, M, C)
        cand_lens = torch.cat([lens[..., None],
                               (lens + 1).clamp(max=C)[..., None].expand(B, W, K)],
                              2).reshape(B, M)
        cand_pb = torch.cat([stay_pb[..., None], neg_wk], 2).reshape(B, M)
        cand_pnb = torch.cat([stay_pnb[..., None], ext_pnb], 2).reshape(B, M)

        # Merge identical prefixes into the first occurrence.
        eq = (cand_prefixes[:, :, None, :] == cand_prefixes[:, None, :, :]).all(dim=-1)
        is_first = ~(eq & earlier).any(dim=-1)
        merged_pb = torch.where(is_first, _group_logsumexp(eq, cand_pb), _NEG_INF)
        merged_pnb = torch.where(is_first, _group_logsumexp(eq, cand_pnb), _NEG_INF)

        order = torch.argsort(-_logaddexp(merged_pb, merged_pnb), dim=1, stable=True)[:, :W]
        keep = keep[:, None]                                       # [B, 1]
        return (torch.where(keep[..., None],
                            cand_prefixes.gather(1, order[..., None].expand(B, W, C)),
                            prefixes),
                torch.where(keep, cand_lens.gather(1, order), lens),
                torch.where(keep, merged_pb.gather(1, order), pb),
                torch.where(keep, merged_pnb.gather(1, order), pnb))

    return step


def _run(state, log_probs, lengths, top_k: int, blank_id: int, lm, lm_weight: float,
         length_bonus: float):
    """Advance a batch of beam states ``([B, W, C], [B, W], [B, W], [B, W])``
    over ``log_probs [B, T, V]``; frames at or past ``lengths [B]`` are
    identity."""
    lp_all = log_probs.to(torch.float32)
    B, T, V = lp_all.shape
    W, C = state[0].shape[1:]
    K = min(top_k, V)
    dev = lp_all.device
    if lm is not None:
        lm = lm.to(device=dev, dtype=torch.float32)
    # Top-K tokens of every frame at once; stable, so ties keep lower ids first.
    top_vals, top_ids = torch.sort(lp_all, dim=-1, descending=True, stable=True)
    top_vals, top_ids = top_vals[..., :K], top_ids[..., :K].to(torch.int32)
    step = _make_step(B, W, C, K, V, blank_id, dev, lm, lm_weight, length_bonus)
    lengths = lengths.to(dev)
    for t in range(T):
        state = step(state, lp_all[:, t], top_vals[:, t], top_ids[:, t], t < lengths)
    return state


def prefix_beam_state_init(beam_width: int, capacity: int, device="cpu"):
    """Fresh beam state ``(prefixes [W, C] int32, lens [W] int64, p_b [W],
    p_nb [W])``: one live beam, the empty prefix with all-blank mass 1
    (``prefix_beam_search.py:161-169``)."""
    pb = torch.full((beam_width,), _NEG_INF, device=device)
    pb[0] = 0.0
    return (torch.full((beam_width, capacity), -1, dtype=torch.int32, device=device),
            torch.zeros((beam_width,), dtype=torch.int64, device=device),
            pb, torch.full((beam_width,), _NEG_INF, device=device))


def prefix_beam_stream_step(state, log_probs: torch.Tensor, length, top_k: int = 8,
                            blank_id: int = 3, lm: torch.Tensor | None = None,
                            lm_weight: float = 0.0, length_bonus: float = 0.0):
    """Continue one stream's prefix beam over a chunk of frames
    (``prefix_beam_search.py:172-212``): ``state`` from
    ``prefix_beam_state_init`` or a previous call, ``log_probs [T_chunk, V]``,
    ``length`` valid frames (the rest are identity).  Feeding chunks is the
    same as one offline pass over their concatenation.  Returns the new state."""
    batched = tuple(x[None] for x in state)
    lengths = torch.as_tensor([int(length)], device=log_probs.device)
    out = _run(batched, log_probs[None], lengths, top_k, blank_id, lm, lm_weight, length_bonus)
    return tuple(x[0] for x in out)


def prefix_beam_search_decode(log_probs: torch.Tensor, lengths: torch.Tensor,
                              beam_width: int = 5, top_k: int = 8, blank_id: int = 3,
                              pad_id: int = -1, lm: torch.Tensor | None = None,
                              lm_weight: float = 0.0, length_bonus: float = 0.0):
    """Batched CTC prefix beam search.

    Args:
      log_probs: ``[B, T, V]`` log-softmaxed scores.
      lengths: ``[B]`` valid frame counts.
      lm / lm_weight / length_bonus: optional shallow fusion with a bigram
        table ``[V+1, V]`` (last row = BOS context): every candidate that emits
        token ``c`` after ``last`` adds ``lm_weight * lm[last, c] + length_bonus``.
    Returns ``(ids [B, T] padded with pad_id, out_lengths [B] int32,
    log_scores [B])``.
    """
    B, T, _ = log_probs.shape
    dev = log_probs.device
    state = tuple(x[None].repeat(B, *([1] * x.ndim))
                  for x in prefix_beam_state_init(beam_width, T, dev))
    prefixes, lens, pb, pnb = _run(state, log_probs, lengths, top_k, blank_id, lm, lm_weight,
                                   length_bonus)
    ids, out_len = prefixes[:, 0], lens[:, 0].to(torch.int32)
    ids = torch.where(torch.arange(T, device=dev)[None, :] < out_len[:, None], ids, pad_id)
    return ids, out_len, _logaddexp(pb, pnb)[:, 0]
