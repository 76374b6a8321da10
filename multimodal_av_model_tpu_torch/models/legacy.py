"""The legacy-v0 model: per-frame CNN + BiGRU lip encoder, BiGRU mel encoder,
concat fusion and one shared CTC head giving twin logit streams.

Mirrors ``multimodal_av_model_tpu/models/legacy.py:23-81``:

* ``LipEncoder`` (``:23-39``): two 3x3 convolutions (padding 1, with bias)
  each followed by ReLU and a 2x2 max-pool of stride 2, over the folded
  ``[B*T, C, H, W]`` frames, then a 2-layer ``BiGRU``.  JAX flattens its
  channels-last ``[H/4, W/4, 64]`` map in H, W, C order, so the NCHW map is
  permuted to NHWC before the reshape: the bridge only transposes kernels;
* ``MelAudioEncoder`` (``:42-51``): a 2-layer ``BiGRU`` over the log-mel;
* ``MultimodalCTCKoreanModel`` (``:54-81``): one lip encoder for both
  speakers, the audio encoder on the mixture's mel, the lips gathered to the
  mel frames at ``clip((arange(T_mel) T_lip) // T_mel, 0, T_lip - 1)`` when
  the two lengths differ, and one ``fc`` head on each ``[lip, audio]``.

``init_legacy_weights`` draws flax's initialisers from a ``torch.Generator``:
lecun-normal (truncated) kernels, orthogonal recurrent kernels per gate, zero
biases.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BiGRU, Dense, _param


class LipEncoder(nn.Module):
    """``[B, T, H, W, C] -> [B, T, 2 hidden]``."""

    def __init__(self, hidden_dim: int = 256, image_size: tuple[int, int] = (96, 96),
                 channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0_weight, self.conv0_bias = _param(32, channels, 3, 3), _param(32)
        self.conv1_weight, self.conv1_bias = _param(64, 32, 3, 3), _param(64)
        h, w = image_size
        self.gru = BiGRU((h // 4) * (w // 4) * 64, hidden_dim, 2, dtype)

    def forward(self, frames, lengths=None):
        dt = self.dtype
        B, T, H, W, C = frames.shape
        x = frames.to(dt).reshape(B * T, H, W, C).permute(0, 3, 1, 2)
        for wt, b in ((self.conv0_weight, self.conv0_bias), (self.conv1_weight, self.conv1_bias)):
            x = F.max_pool2d(F.relu(F.conv2d(x, wt.to(dt), b.to(dt), padding=1)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(B, T, -1)                   # flax's H, W, C order
        return self.gru(x, lengths)


class MelAudioEncoder(nn.Module):
    """``[B, T, n_mels] -> [B, T, 2 hidden]``."""

    def __init__(self, hidden_dim: int = 256, n_mels: int = 80,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gru = BiGRU(n_mels, hidden_dim, 2, dtype)

    def forward(self, mel, lengths=None):
        return self.gru(mel.to(self.dtype), lengths)


class MultimodalCTCKoreanModel(nn.Module):
    """``(frames_a, frames_b, mel, mel_lengths) -> (logits_a, logits_b)``,
    each ``[B, T_mel, vocab]``."""

    def __init__(self, vocab_size: int, hidden_dim: int = 256,
                 image_size: tuple[int, int] = (96, 96), channels: int = 3, n_mels: int = 80,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lip_encoder = LipEncoder(hidden_dim, image_size, channels, dtype)
        self.audio_encoder = MelAudioEncoder(hidden_dim, n_mels, dtype)
        self.fc = Dense(4 * hidden_dim, vocab_size, dtype=dtype)

    def forward(self, frames_a, frames_b, mel, mel_lengths=None):
        feat_a = self.lip_encoder(frames_a)
        feat_b = self.lip_encoder(frames_b)
        audio = self.audio_encoder(mel, mel_lengths)
        T_mel, T_lip = audio.shape[1], feat_a.shape[1]
        if T_lip != T_mel:
            idx = ((torch.arange(T_mel, device=audio.device) * T_lip) // T_mel).clamp(0, T_lip - 1)
            feat_a, feat_b = feat_a[:, idx], feat_b[:, idx]
        return (self.fc(torch.cat([feat_a, audio], dim=-1)),
                self.fc(torch.cat([feat_b, audio], dim=-1)))


# flax's variance_scaling "truncated_normal": the std of a unit normal cut at
# +-2, divided out so that the kept draws have the asked-for variance.
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_legacy_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initialisers for ``MultimodalCTCKoreanModel``, drawn on the CPU
    from ``generator`` and copied to each parameter's device: conv, input
    and head kernels lecun-normal (truncated at two standard deviations,
    fan-in scaled), the recurrent kernels ``hr``, ``hz``, ``hn`` orthogonal
    (each gate's ``[H, H]`` block), biases 0."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("bias") or leaf in ("b_ih", "b_hn"):
            p.zero_()
        elif leaf == "w_hh":
            H = p.shape[-1]
            blocks = p.detach().cpu().reshape(-1, H, H)                 # one per gate
            for blk in blocks:
                nn.init.orthogonal_(blk, generator=generator)
            p.copy_(blocks.reshape(p.shape))
        else:
            fan_in = p.shape[-1] if leaf in ("w_ih", "weight") else p[0].numel()
            std = 1.0 / math.sqrt(fan_in) / _TRUNCATED_STD
            draw = nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std, -2 * std, 2 * std,
                                         generator=generator)
            p.copy_(draw)
    return model
