"""Sequence-parallel (context-parallel) attention: time split over a mesh axis.

Mirrors ``multimodal_av_model_tpu/parallel/sequence.py:1-175``.  JAX writes
each function once over the whole ``[T, ...]`` array and ``shard_map`` gives
every device its block of ``P(seq_axis)``; here every rank is one process,
so each function is that local view: a rank passes its own time block of
Q, K and V (``local_block`` cuts it from a whole tensor) and gets its own
block of the output back.  No rank holds another's Q.

* ``gather_kv_attention`` all-gathers K and V along time (one collective,
  with a gradient: ``parallel/mesh.py:gather_rows``) and attends its Q rows
  to all of them, in the input dtype with the scale cast to it
  (``sequence.py:38-52``, ``:117-128``);
* ``ring_attention`` attends to the K/V block it holds, then hands the block
  on with ``ring_hop`` (``lax.ppermute``), ``n`` times, with f32 online
  softmax: ``m`` from ``-inf``, ``l``, ``acc``; the scale ``1/sqrt(D)`` on
  the f32 logits; the output cast back to the input dtype
  (``sequence.py:55-99``, ``:131-175``).  K/V memory per rank is one block.
  JAX hops after the last step too, bringing the blocks home; that hop's
  result is unused, so it is left out.

Both scale the logits, not ``q`` as ``models/layers.py:MultiHeadAttention``
(flax's order) does.  ``reference_attention`` is the unsharded oracle
(``sequence.py:102-105``).
"""

from __future__ import annotations

import torch

from .mesh import axis_rank, axis_size, gather_rows, ring_hop


def _scale(q: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``1.0 / jnp.sqrt(D).astype(dtype)`` for ``q``'s head size ``D``: the
    root in f32, cast, then the reciprocal in ``dtype``, on ``q``'s device."""
    root = torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32, device=q.device))
    return 1.0 / root.to(dtype)


def local_block(x: torch.Tensor, mesh, seq_axis: str = "data", dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (time) when it is split over
    ``seq_axis`` in rank order; raises ``ValueError`` when the axis size does
    not divide the length (JAX's ``shard_map`` refuses it too)."""
    n, T = axis_size(mesh, seq_axis), x.shape[dim]
    if T % n:
        raise ValueError(f"time length T={T} is not divisible by the {seq_axis!r} axis "
                         f"size {n}")
    return x.narrow(dim, axis_rank(mesh, seq_axis) * (T // n), T // n)


def gather_time(x: torch.Tensor, mesh, seq_axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``x`` of every rank of ``seq_axis``, joined along
    ``dim`` in rank order; the gradient of each rank's use flows back to its
    own block."""
    if axis_size(mesh, seq_axis) == 1:
        return x
    return gather_rows(x.movedim(dim, 0), mesh, seq_axis).movedim(0, dim)


def _attend(q, k, v, scale):
    logits = torch.einsum("thd,shd->hts", q, k) * scale
    return torch.einsum("hts,shd->thd", torch.softmax(logits, dim=-1), v)


def _attend_batched(q, k, v, scale):
    logits = torch.einsum("bthd,bshd->bhts", q, k) * scale
    return torch.einsum("bhts,bshd->bthd", torch.softmax(logits, dim=-1), v)


def reference_attention(q, k, v):
    """Unsharded attention over ``[T, H, D]`` (``sequence.py:102-105``)."""
    return _attend(q, k, v, _scale(q, q.dtype))


def gather_kv_attention(q, k, v, mesh, seq_axis: str = "data"):
    """Exact attention of this rank's ``[T/n, H, D]`` block of Q against the
    whole of K and V, gathered along time (``sequence.py:38-52``)."""
    scale = _scale(q, q.dtype)
    return _attend(q, gather_time(k, mesh, seq_axis, 0), gather_time(v, mesh, seq_axis, 0),
                   scale)


def gather_kv_attention_batched(q, k, v, mesh, seq_axis: str = "data"):
    """``gather_kv_attention`` over ``[B, T/n, H, D]`` blocks
    (``sequence.py:117-128``)."""
    scale = _scale(q, q.dtype)
    return _attend_batched(q, gather_time(k, mesh, seq_axis, 1),
                           gather_time(v, mesh, seq_axis, 1), scale)


def _ring(q, k, v, mesh, seq_axis, batched: bool):
    """The online-softmax ring over ``[.., T, H, D]`` blocks; ``batched``
    puts a batch axis in front."""
    n = axis_size(mesh, seq_axis)
    scale = _scale(q, torch.float32)
    qk, pv = ("bthd,bshd->bhts", "bhts,bshd->bthd") if batched else ("thd,shd->hts",
                                                                        "hts,shd->thd")
    qf = q.float()
    stats = q.shape[:-3] + (q.shape[-2], q.shape[-3])          # [(B,) H, T]
    m = torch.full(stats, float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros(stats, dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for step in range(n):
        logits = torch.einsum(qk, qf, k_cur.float()) * scale
        new_m = torch.maximum(m, logits.amax(dim=-1))
        correction = torch.exp(m - new_m)
        p = torch.exp(logits - new_m[..., None])
        l = l * correction + p.sum(dim=-1)
        acc = acc * correction.transpose(-1, -2)[..., None] + torch.einsum(pv, p, v_cur.float())
        m = new_m
        if step < n - 1:
            k_cur, v_cur = ring_hop(k_cur, mesh, seq_axis), ring_hop(v_cur, mesh, seq_axis)
    return (acc / l.transpose(-1, -2)[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, seq_axis: str = "data"):
    """Exact attention of this rank's ``[T/n, H, D]`` blocks with K/V blocks
    going round the ring (``sequence.py:55-99``)."""
    return _ring(q, k, v, mesh, seq_axis, batched=False)


def ring_attention_batched(q, k, v, mesh, seq_axis: str = "data"):
    """``ring_attention`` over ``[B, T/n, H, D]`` blocks
    (``sequence.py:131-175``)."""
    return _ring(q, k, v, mesh, seq_axis, batched=True)
