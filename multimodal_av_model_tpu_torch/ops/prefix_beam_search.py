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

Every decode goes through the operator ``mmav::prefix_beam``
(``torch.library.custom_op``; the offline decode, the streaming step, and so
the service, ``trainer.evaluate``, the families and the exported program): on
a CUDA tensor it launches ``csrc/prefix_beam.cu`` (K3), one CTA per row with
the frame loop inside it, or raises; on a CPU tensor it takes the plain loop
below, which the CPU tests hold against JAX.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from . import cuda_build
from .cuda_build import SMEM_LIMIT

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
    (``prefix_beam_search.py:161-169``).  Built on ``device`` without a
    copy from the host."""
    pb = torch.full((beam_width,), _NEG_INF, device=device)
    pb[:1].fill_(0.0)
    return (torch.full((beam_width, capacity), -1, dtype=torch.int32, device=device),
            torch.zeros((beam_width,), dtype=torch.int64, device=device),
            pb, torch.full((beam_width,), _NEG_INF, device=device))


def _prefix_beam_plain(log_probs, lengths, prefixes, lens, pb, pnb, lm, beam_width, top_k,
                       blank_id, pad_id, lm_weight, length_bonus):
    """The plain version of ``mmav::prefix_beam``: ``_run`` from the given
    state, or from ``prefix_beam_state_init(beam_width, T)`` on every row,
    then the best beam's ids (padded with ``pad_id``), length and score."""
    B, T, _ = log_probs.shape
    dev = log_probs.device
    if prefixes is None:
        state = tuple(x[None].repeat(B, *([1] * x.ndim))
                      for x in prefix_beam_state_init(beam_width, T, dev))
    else:
        state = tuple(x.clone() for x in (prefixes, lens, pb, pnb))   # outputs alias no input
    prefixes, lens, pb, pnb = _run(state, log_probs, lengths, top_k, blank_id, lm, lm_weight,
                                   length_bonus)
    out_len = lens[:, 0].to(torch.int32)
    C = prefixes.shape[2]
    ids = torch.where(torch.arange(C, device=dev)[None, :] < out_len[:, None], prefixes[:, 0],
                      pad_id)
    return prefixes, lens, pb, pnb, ids, out_len, _logaddexp(pb[:, 0], pnb[:, 0])


# The frames whose top-K the kernel stages at once, at most.
_TILE_FRAMES = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=64)
def prefix_beam_plan(T: int, W: int, K: int, C: int) -> dict:
    """Launch plan of ``csrc/prefix_beam.cu`` for ``T`` frames, ``W`` beams,
    the top ``K`` tokens and prefixes of ``C``: ``tile`` (frames whose top-K
    sit in shared memory at once; fewer where ``K`` is large),
    ``rows_in_smem`` (both prefix buffers, 8 W C bytes, fit in shared memory
    beside the rest) and ``smem_bytes`` (the kernel's layout: 8 bytes a beam
    and a candidate for the hashes, 32 a beam, 48 a candidate and 4 for a
    flag for the rest, 8 a staged token and 4 a staged frame's blank, then
    the buffers if they fit).  ``M = W * (K + 1)`` candidates a frame."""
    M = W * (K + 1)
    fixed = 40 * W + 56 * M + 4
    tile = max(1, min(_TILE_FRAMES, T, (SMEM_LIMIT - fixed) // (8 * K + 4)))
    smem = fixed + tile * (8 * K + 4)
    rows_in_smem = smem + 8 * W * C <= SMEM_LIMIT
    return {"M": M, "tile": tile, "rows_in_smem": rows_in_smem,
            "smem_bytes": smem + (8 * W * C if rows_in_smem else 0)}


_launch = cuda_build.Launcher(
    "prefix_beam", "mmav_prefix_beam",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 13
    + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2)


def _prefix_beam_launch(log_probs, lengths, prefixes, lens, pb, pnb, lm, beam_width, top_k,
                        blank_id, pad_id, lm_weight, length_bonus):
    """The ``"cuda"`` kernel of ``mmav::prefix_beam``: one launch of
    ``csrc/prefix_beam.cu`` over every row, counted in
    ``prefix_beam.launches`` and, with the recorder on, as
    ``prefix_beam_kernel`` of the innermost span.  Raises on anything the
    kernel does not take."""
    if log_probs.dtype not in _DTYPES:
        raise TypeError(f"prefix-beam kernel: expected f32 or bf16 log-probs, got "
                        f"{log_probs.dtype}")
    if log_probs.ndim != 3:
        raise ValueError(f"prefix-beam kernel: expected [B, T, V] log-probs, got "
                         f"{tuple(log_probs.shape)}")
    B, T, V = log_probs.shape
    dev = log_probs.device
    if lengths.shape != (B,) or lengths.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"prefix-beam kernel: expected [{B}] int32 or int64 lengths, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if prefixes is not None:
        W, C = prefixes.shape[1:]
        want = ((prefixes, (B, W, C), torch.int32), (lens, (B, W), torch.int64),
                (pb, (B, W), torch.float32), (pnb, (B, W), torch.float32))
        if any(x is None or x.shape != shape or x.dtype != dt or x.device != dev
               for x, shape, dt in want):
            raise ValueError("prefix-beam kernel: the state must be prefixes [B, W, C] int32, "
                             "lens [B, W] int64, pb and pnb [B, W] float32 on the log-probs' "
                             "device")
        prefixes, lens, pb, pnb = (x.contiguous() for x in (prefixes, lens, pb, pnb))
    else:
        W, C = beam_width, T
    K = min(top_k, V)
    if W < 1 or K < 1 or not 0 <= blank_id < V:
        raise ValueError(f"prefix-beam kernel: beam width {W}, top-k {K} and blank "
                         f"{blank_id} of {V} tokens")
    if lm is not None:
        if lm.shape != (V + 1, V):
            raise ValueError(f"prefix-beam kernel: expected a [{V + 1}, {V}] bigram table, got "
                             f"{tuple(lm.shape)}")
        lm = lm.to(device=dev, dtype=torch.float32).contiguous()
    plan = prefix_beam_plan(T, W, K, C)
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(f"prefix-beam kernel: {plan['M']} candidates a frame need "
                         f"{plan['smem_bytes']} bytes of shared memory, more than {SMEM_LIMIT}")
    log_probs, lengths = log_probs.contiguous(), lengths.to(dev)
    out = (torch.empty((B, W, C), dtype=torch.int32, device=dev),
           torch.empty((B, W), dtype=torch.int64, device=dev),
           torch.empty((B, W), dtype=torch.float32, device=dev),
           torch.empty((B, W), dtype=torch.float32, device=dev),
           torch.empty((B, C), dtype=torch.int32, device=dev),
           torch.empty((B,), dtype=torch.int32, device=dev),
           torch.empty((B,), dtype=torch.float32, device=dev))
    if B == 0:
        return out
    scratch = None if plan["rows_in_smem"] else torch.empty((B, W, C), dtype=torch.int32,
                                                            device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    _launch(dev, prefix_beam, log_probs.data_ptr(), _DTYPES[log_probs.dtype], lengths.data_ptr(),
            int(lengths.dtype == torch.int64), ptr(prefixes), ptr(lens), ptr(pb), ptr(pnb),
            ptr(lm), out[0].data_ptr(), ptr(scratch), *(x.data_ptr() for x in out[1:]), B, T, V,
            W, C, K, plan["tile"], blank_id, pad_id, lm_weight, length_bonus,
            int(plan["rows_in_smem"]), plan["smem_bytes"])
    tracing.count("prefix_beam_kernel", 1)
    return out


# K3 as an operator (as K1 in ops/logmel.py): the CUDA kernel on the card, the
# plain loop on the CPU, a fake for the outputs' shapes, so that torch.export
# holds the whole decode as one node.  No autograd: the decode is not
# differentiable.
prefix_beam_op = torch.library.custom_op(
    "mmav::prefix_beam", _prefix_beam_launch, mutates_args=(), device_types="cuda",
    schema="(Tensor log_probs, Tensor lengths, Tensor? prefixes, Tensor? lens, Tensor? pb, "
           "Tensor? pnb, Tensor? lm, int beam_width, int top_k, int blank_id, int pad_id, "
           "float lm_weight, float length_bonus) "
           "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
prefix_beam_op.register_kernel("cpu")(_prefix_beam_plain)


@prefix_beam_op.register_fake
def _prefix_beam_fake(log_probs, lengths, prefixes, lens, pb, pnb, lm, beam_width, top_k,
                      blank_id, pad_id, lm_weight, length_bonus):
    B, T, _ = log_probs.shape
    W, C = (beam_width, T) if prefixes is None else prefixes.shape[1:]
    new = log_probs.new_empty
    return (new((B, W, C), dtype=torch.int32), new((B, W), dtype=torch.int64),
            new((B, W), dtype=torch.float32), new((B, W), dtype=torch.float32),
            new((B, C), dtype=torch.int32), new((B,), dtype=torch.int32),
            new((B,), dtype=torch.float32))


def prefix_beam(log_probs: torch.Tensor, lengths: torch.Tensor, state=None,
                beam_width: int = 5, top_k: int = 8, blank_id: int = 3, pad_id: int = -1,
                lm: torch.Tensor | None = None, lm_weight: float = 0.0,
                length_bonus: float = 0.0):
    """Advance a batch of beam states over ``log_probs [B, T, V]`` through
    the operator ``mmav::prefix_beam``; frames at or past ``lengths [B]``
    are identity.

    ``state``: ``(prefixes [B, W, C] int32, lens [B, W] int64, pb, pnb [B, W]
    f32)``, or None for ``prefix_beam_state_init(beam_width, T)`` on every
    row.  Returns ``(state, ids [B, C] padded with pad_id, out_len [B] int32,
    log_scores [B])``, the last three of the best beam.  A CUDA tensor
    launches ``csrc/prefix_beam.cu`` (counted in ``prefix_beam.launches``) or
    raises; a CPU tensor takes the plain loop.
    """
    if log_probs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"prefix-beam kernel: unsupported device {log_probs.device}")
    *new, ids, out_len, score = prefix_beam_op(
        log_probs, lengths, *(state if state is not None else (None,) * 4), lm,
        int(beam_width), int(top_k), int(blank_id), int(pad_id), float(lm_weight),
        float(length_bonus))
    return tuple(new), ids, out_len, score


prefix_beam.launches = 0


def prefix_beam_stream_step(state, log_probs: torch.Tensor, length, top_k: int = 8,
                            blank_id: int = 3, lm: torch.Tensor | None = None,
                            lm_weight: float = 0.0, length_bonus: float = 0.0):
    """Continue one stream's prefix beam over a chunk of frames
    (``prefix_beam_search.py:172-212``): ``state`` from
    ``prefix_beam_state_init`` or a previous call, ``log_probs [T_chunk, V]``,
    ``length`` valid frames (the rest are identity).  Feeding chunks is the
    same as one offline pass over their concatenation.  Returns the new state."""
    lengths = torch.full((1,), int(length), dtype=torch.int64, device=log_probs.device)
    out, _, _, _ = prefix_beam(log_probs[None], lengths, tuple(x[None] for x in state),
                               state[0].shape[0], top_k, blank_id, lm=lm, lm_weight=lm_weight,
                               length_bonus=length_bonus)
    return tuple(x[0] for x in out)


def prefix_beam_search_decode(log_probs: torch.Tensor, lengths: torch.Tensor,
                              beam_width: int = 5, top_k: int = 8, blank_id: int = 3,
                              pad_id: int = -1, lm: torch.Tensor | None = None,
                              lm_weight: float = 0.0, length_bonus: float = 0.0):
    """Batched CTC prefix beam search, one ``mmav::prefix_beam`` call.

    Args:
      log_probs: ``[B, T, V]`` log-softmaxed scores.
      lengths: ``[B]`` valid frame counts.
      lm / lm_weight / length_bonus: optional shallow fusion with a bigram
        table ``[V+1, V]`` (last row = BOS context): every candidate that emits
        token ``c`` after ``last`` adds ``lm_weight * lm[last, c] + length_bonus``.
    Returns ``(ids [B, T] padded with pad_id, out_lengths [B] int32,
    log_scores [B])``.
    """
    _, ids, out_len, score = prefix_beam(log_probs, lengths, None, beam_width, top_k, blank_id,
                                         pad_id, lm, lm_weight, length_bonus)
    return ids, out_len, score
