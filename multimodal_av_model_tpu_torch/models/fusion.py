"""Cross-attention audio-visual fusion with static-shape masked frame logic.

Mirrors ``multimodal_av_model_tpu/models/fusion.py:36-141``. Audio frames
whose speaker mask is 0 or 3 are dropped by a stable argsort compaction; the
kept frames are resampled to the visual length over the batch-max kept length
``t_in``, which stays a device tensor (no host sync); the mask is resampled
with integer nearest-neighbour math; audio queries the visual stream through
multi-head attention; a BiLSTM, or with ``temporal_model="transformer"`` a
transformer and a Dense to ``2 fused_dim``, runs over the fused sequence.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import FusionConfig
from ..data.mixing import MASK_OTHER_SOLO, MASK_PAD
from ..ops.lstm_scan import length_mask
from ..tracing import span
from .layers import BiLSTM, Dense, MultiHeadAttention, TransformerTemporalBlock


def compact_speech_frames(audio_feat, mask):
    """Move frames with mask not in {0, 3} to the front (stable), zero the rest.

    Returns ``(audio_c [B,Ta,D], mask_c [B,Ta], kept [B])``.
    """
    speech = (mask != MASK_OTHER_SOLO) & (mask != MASK_PAD)
    order = torch.argsort((~speech).to(torch.int32), dim=1, stable=True)   # kept first
    audio_c = torch.take_along_dim(audio_feat, order[..., None], dim=1)
    mask_c = torch.take_along_dim(mask, order, dim=1)
    kept = speech.sum(dim=1).to(torch.int32)
    cvalid = length_mask(kept, mask.shape[1])
    audio_c = torch.where(cvalid[..., None], audio_c, 0.0)
    mask_c = torch.where(cvalid, mask_c, 0)
    return audio_c, mask_c, kept


def interp_linear_to(audio_c, t_in, T_v: int):
    """Linear resample ``audio_c[:, :t_in] -> [:, T_v]`` with ``align_corners``;
    ``t_in`` is a 0-d device tensor (the batch-max kept length)."""
    t_in = torch.clamp(t_in, min=1)
    j = torch.arange(T_v, dtype=torch.float32, device=audio_c.device)
    scale = (t_in - 1).to(torch.float32) / max(T_v - 1, 1)
    src = j * scale
    lo = torch.floor(src).to(torch.int64)
    hi = torch.minimum(lo + 1, t_in - 1)
    frac = (src - lo).to(audio_c.dtype)
    a_lo = audio_c.index_select(1, lo)
    a_hi = audio_c.index_select(1, hi)
    return a_lo + (a_hi - a_lo) * frac[None, :, None]


def interp_nearest_mask(mask_c, t_in, T_v: int):
    """Nearest resample of the compacted mask; integer index math is exact."""
    t_in = torch.clamp(t_in, min=1).to(torch.int64)
    j = torch.arange(T_v, dtype=torch.int64, device=mask_c.device)
    idx = torch.minimum(torch.div(j * t_in, T_v, rounding_mode="floor"), t_in - 1)
    return mask_c.index_select(1, idx)


class CrossAttentionFusion(nn.Module):
    """``fusion.py:78-141``: ``(fused [B, T_v, 2 fused_dim], input_lengths [B])``.

    ``group``: a process group over which the batch is split (the mesh's
    ``data`` axis, set by ``parallel.bind_data_axis``); ``t_in`` is then the
    max over the whole batch, all-reduced, as under ``pjit``."""

    def __init__(self, config: FusionConfig, visual_dim: int, audio_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = config.fused_dim
        self.config, self.dtype = config, dtype
        self.group = None
        self.visual_proj = Dense(visual_dim, d, dtype=dtype)
        self.audio_proj = Dense(audio_dim, d, dtype=dtype)
        self.cross_attn_audio = MultiHeadAttention(d, config.num_heads, dtype)
        self.fusion_proj = Dense(d, d, dtype=dtype)
        if config.temporal_model == "bilstm":
            self.temporal_bilstm = BiLSTM(d, d, config.temporal_layers, dtype)
        elif config.temporal_model == "transformer":      # fusion.py:130-137
            self.temporal_tf = TransformerTemporalBlock(
                d, config.temporal_layers, config.transformer_heads,
                config.transformer_ffn_dim, dtype)
            self.temporal_out = Dense(d, 2 * d, dtype=dtype)
        else:
            raise ValueError(f"unknown temporal model {config.temporal_model!r}")

    def forward(self, visual_feat, audio_feat, mask, visual_lengths=None):
        """Args:
          visual_feat: ``[B, T_v, D_v]``.
          audio_feat: ``[B, T_a, D_a]`` encoder-rate audio features.
          mask: ``[B, T_a]`` int speaker mask at encoder rate.
          visual_lengths: optional ``[B]``; masks padded visual keys and the
            temporal model.
        """
        B, T_v, _ = visual_feat.shape
        audio_c, mask_c, kept = compact_speech_frames(audio_feat.to(self.dtype), mask)
        t_in = kept.max()                                          # device scalar
        if self.group is not None:
            torch.distributed.all_reduce(t_in, torch.distributed.ReduceOp.MAX, self.group)
        a_i = interp_linear_to(audio_c, t_in, T_v)
        mask_i = interp_nearest_mask(mask_c, t_in, T_v)

        v = self.visual_proj(visual_feat)
        a = self.audio_proj(a_i)
        attn_mask = None
        if visual_lengths is not None:
            attn_mask = length_mask(visual_lengths, T_v)[:, None, None, :]
        a2v = self.cross_attn_audio(a, v, attn_mask)
        fused = self.fusion_proj(a2v)
        with span("fusion.temporal"):
            if self.config.temporal_model == "bilstm":
                fused_seq = self.temporal_bilstm(fused, visual_lengths)
            else:
                fused_seq = self.temporal_out(self.temporal_tf(fused, visual_lengths))
        input_lengths = (mask_i != 0).sum(dim=1).to(torch.int32)
        return fused_seq, input_lengths
