"""CTC decoder head: linear projection to the vocabulary + f32 log-softmax.

Mirrors ``multimodal_av_model_tpu/models/decoder.py:19-27``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import DecoderConfig
from .layers import Dense


class CTCDecoder(nn.Module):
    def __init__(self, config: DecoderConfig, in_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head = Dense(in_dim, config.vocab_size, dtype=dtype)

    def forward(self, x):
        """``[B, T, D] -> [B, T, V]`` log-probabilities (f32)."""
        return torch.log_softmax(self.head(x).to(torch.float32), dim=-1)
