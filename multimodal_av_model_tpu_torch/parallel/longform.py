"""Long-form context parallelism: the audio encoder with its attention split
over time.

Mirrors ``multimodal_av_model_tpu/parallel/longform.py:1-81``: the standard
``AudioEncoder`` with ``CPSelfAttention`` in its attention slot, which keeps
``MultiHeadAttention``'s ``query``/``key``/``value``/``out`` parameters, so a
full-attention encoder's state dict (the flagship's ``audio_encoder.*``, a
``--family=ssl`` checkpoint, ``compat.audio_encoder_from_jax``) loads as is.

Every rank of the ``seq_axis`` group holds the whole activations
(``[B, T, d]``: 0.1 GB at 48,000 frames of 512) and runs the position-wise
work, K1 and the depthwise convolution on them in full; only the attention,
whose ``T x T`` logits are what one card cannot hold, is split: each rank
projects its time block of the queries, keys and values, runs the ring or
gather-KV attention of ``parallel/sequence.py`` on it, projects its block of
the output, and the blocks are all-gathered along time.

As in JAX (the CAVEAT of ``longform.py:15-18``, ``:50``), the attention is
FULL: the mask is dropped, so a padded batch differs from the standard
encoder's; this is for one pad-free stream a row.  The path is inference
only: JAX keeps ``dropout_rate`` and ``deterministic`` to match flax MHA's
constructor, and no attention dropout runs here either.
"""

from __future__ import annotations

import functools

import torch

from ..config import require_flagship
from ..models.audio import AudioEncoder
from ..models.layers import MultiHeadAttention
from .sequence import gather_kv_attention_batched, gather_time, local_block, ring_attention_batched

IMPLS = {"ring": ring_attention_batched, "gather": gather_kv_attention_batched}


class CPSelfAttention(MultiHeadAttention):
    """Self-attention with time split over ``seq_axis`` of ``mesh``
    (``longform.py:33-65``); ``impl``: ``"ring"`` (one K/V block a rank) or
    ``"gather"``."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, *, mesh, seq_axis: str = "data",
                 impl: str = "ring"):
        if dim % num_heads:
            raise ValueError(f"d_model {dim} not divisible by {num_heads} heads")
        if impl not in IMPLS:
            raise ValueError(f"impl {impl!r}: one of {sorted(IMPLS)}")
        super().__init__(dim, num_heads, dtype, dropout_rate)
        self.mesh, self.seq_axis, self.attend = mesh, seq_axis, IMPLS[impl]

    def forward(self, q_in, kv_in, mask=None, generator=None):
        """``mask`` and ``generator`` are ignored: full attention, no dropout."""
        del mask, generator
        mesh, axis = self.mesh, self.seq_axis
        B, H, hd = q_in.shape[0], self.num_heads, self.head_dim

        def heads(x):
            return x.reshape(B, -1, H, hd)                         # [B, T/n, H, hd]

        q = heads(self.query(local_block(q_in, mesh, axis, dim=1)))
        kv_blk = local_block(kv_in, mesh, axis, dim=1)
        out = self.attend(q, heads(self.key(kv_blk)), heads(self.value(kv_blk)), mesh, axis)
        return gather_time(self.out(out.reshape(B, -1, H * hd)), mesh, axis, 1)


def make_cp_audio_encoder(model_cfg, mesh, seq_axis: str = "data", impl: str = "ring",
                          dtype: torch.dtype = torch.float32) -> AudioEncoder:
    """The standard ``AudioEncoder`` with ``CPSelfAttention`` in every block,
    in ``dtype`` (f32 by default, as JAX's) (``longform.py:68-81``).  Every
    rank of ``seq_axis`` calls it on the same waveform and gets the whole
    output."""
    require_flagship(model_cfg, "the long-form encoder")
    attn = functools.partial(CPSelfAttention, mesh=mesh, seq_axis=seq_axis, impl=impl)
    return AudioEncoder(model_cfg.audio, model_cfg.frontend, dtype, attention=attn)
