"""Audio encoder: log-mel frontend (kernel K1) + Conformer stack with mid-layer taps.

Mirrors ``multimodal_av_model_tpu/models/audio.py:35-217``: half-step FFN,
MHSA, GLU + depthwise-conv module, half-step FFN and a final LayerNorm per
block; a stride-2 conv subsampler; sinusoidal positions; frame validity from
the hop-anchor samples; the mean of the configured middle layers as a tap.
Convolutions pad as flax ``padding="SAME"`` does, explicitly: at stride 2,
kernel 5 and even T that is 1 on the left and 2 on the right.  In train mode
(a dropout ``generator`` is given) dropout at ``config.dropout`` runs at the
sites of ``audio.py:35-103``: twice in each FFN (after the swish and after the
second Dense), at the conv module's output and on the attention weights.
The log-mel frontend (K1) takes no gradient, as under ``stop_gradient``
(``audio.py:144-153``).  The two train-mode hooks of the audio-only and SSL
families work on K1's detached output, never on a tensor that needs a
gradient: SpecAugment on the log-mel, drawn from the dropout generator
(``audio.py:169-182``), and the SSL span masking after the subsampler
(``audio.py:193-201``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AudioEncoderConfig, AudioFrontendConfig
from ..ops.logmel import log_mel_spectrogram_cuda, num_frames
from ..ops.specaugment import spec_augment
from .layers import Dense, LayerNorm, MultiHeadAttention, _param, dropout, sinusoidal_positions


def same_padding(n: int, kernel: int, stride: int) -> tuple[int, int]:
    """(left, right) padding of XLA/flax ``SAME`` for a length-``n`` axis."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def conv1d_same(x, weight, bias, stride: int = 1, groups: int = 1):
    """``[B, T, C_in] -> [B, T_out, C_out]`` with flax SAME padding."""
    k = weight.shape[-1]
    h = F.pad(x.transpose(1, 2), same_padding(x.shape[1], k, stride))
    return F.conv1d(h, weight, bias, stride=stride, groups=groups).transpose(1, 2)


class FeedForward(nn.Module):
    """``audio.py:35-47``.  ``rows`` and ``hidden_cols`` place this rank's
    block of the batch and of the hidden features in the mesh's whole
    (``layers.dropout``; set by ``parallel``); ``parts`` is 2 in the encoder
    of the double audio pass (set by ``MultiSpeakerAVModel``)."""

    def __init__(self, dim: int, ffn_dim: int, dropout_rate: float, dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(dim, dtype)
        self.fc1 = Dense(dim, ffn_dim, dtype=dtype)
        self.fc2 = Dense(ffn_dim, dim, dtype=dtype)
        self.dropout_rate = dropout_rate
        self.rows = self.hidden_cols = (0, 1)
        self.parts = 1

    def forward(self, x, generator=None):
        h = dropout(F.silu(self.fc1(self.norm(x))), self.dropout_rate, generator,
                    rows=self.rows, cols=self.hidden_cols, parts=self.parts)
        return dropout(self.fc2(h), self.dropout_rate, generator, rows=self.rows,
                       parts=self.parts)


class ConvModule(nn.Module):
    """``audio.py:50-68``: LN, pointwise GLU, padded frames zeroed, depthwise
    conv (SAME), LN, swish, pointwise.  ``rows`` and ``parts`` as
    ``FeedForward``'s."""

    def __init__(self, dim: int, kernel_size: int, dropout_rate: float, dtype: torch.dtype):
        super().__init__()
        self.norm = LayerNorm(dim, dtype)
        self.pointwise_in = Dense(dim, 2 * dim, dtype=dtype)
        self.depthwise_weight = _param(dim, 1, kernel_size)
        self.depthwise_bias = _param(dim)
        self.depthwise_norm = LayerNorm(dim, dtype)
        self.pointwise_out = Dense(dim, dim, dtype=dtype)
        self.dtype, self.dropout_rate = dtype, dropout_rate
        self.rows, self.parts = (0, 1), 1

    def forward(self, x, valid, generator=None):
        dt = self.dtype
        a, b = self.pointwise_in(self.norm(x)).chunk(2, dim=-1)
        h = torch.where(valid[..., None], a * torch.sigmoid(b), 0.0)
        h = conv1d_same(h, self.depthwise_weight.to(dt), self.depthwise_bias.to(dt),
                        groups=h.shape[-1])
        h = self.pointwise_out(F.silu(self.depthwise_norm(h)))
        return dropout(h, self.dropout_rate, generator, rows=self.rows, parts=self.parts)


class ConformerBlock(nn.Module):
    """``audio.py:71-103``.  ``attention``: the self-attention's constructor,
    ``(dim, num_heads, dtype, dropout_rate) -> module`` called as
    ``module(q_in, kv_in, mask, generator)`` (``attention_module``,
    ``audio.py:78-81``); None is ``MultiHeadAttention``.  A replacement keeps
    its ``query``/``key``/``value``/``out`` parameters, so state dicts
    interchange (``parallel/longform.py``)."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int, kernel_size: int,
                 dropout_rate: float, dtype: torch.dtype, attention=None):
        super().__init__()
        self.ff1 = FeedForward(dim, ffn_dim, dropout_rate, dtype)
        self.attn_norm = LayerNorm(dim, dtype)
        self.attn = (attention or MultiHeadAttention)(dim, num_heads, dtype, dropout_rate)
        self.conv = ConvModule(dim, kernel_size, dropout_rate, dtype)
        self.ff2 = FeedForward(dim, ffn_dim, dropout_rate, dtype)
        self.final_norm = LayerNorm(dim, dtype)

    def forward(self, x, valid, attn_mask, generator=None):
        x = x + 0.5 * self.ff1(x, generator)
        h = self.attn_norm(x)
        x = x + self.attn(h, h, attn_mask, generator)
        x = x + self.conv(x, valid, generator)
        x = x + 0.5 * self.ff2(x, generator)
        return self.final_norm(x)


class AudioEncoder(nn.Module):
    """Raw waveform -> ``(last [B, T_enc, output_dim], middle [B, T_enc, d_model],
    frame_valid [B, T_enc])``, and ``ssl_targets`` fourth when ``mask_spans``
    is given (``audio.py:106-217``).

    ``mask_embedding``: build the learned ``[d_model]`` vector that replaces
    masked positions (the SSL model's encoder; flax creates the parameter
    only when ``mask_spans`` is given, so the flagship's encoder has none).
    ``attention``: every block's self-attention constructor
    (``ConformerBlock``; ``audio.py:110``, ``:208-211``).  ``rows`` and
    ``parts`` place SpecAugment's draws as ``FeedForward``'s dropout."""

    def __init__(self, config: AudioEncoderConfig, frontend: AudioFrontendConfig,
                 dtype: torch.dtype = torch.float32, mask_embedding: bool = False,
                 attention=None):
        super().__init__()
        cfg = config
        if cfg.middle_layers and max(cfg.middle_layers) >= cfg.num_layers:
            raise ValueError(f"middle_layers {cfg.middle_layers} out of range for "
                             f"num_layers={cfg.num_layers}")
        self.config, self.frontend, self.dtype = config, frontend, dtype
        self.subsample_weight = _param(cfg.d_model, frontend.n_mels, 5)
        self.subsample_bias = _param(cfg.d_model)
        self.blocks = nn.ModuleList(
            ConformerBlock(cfg.d_model, cfg.num_heads, cfg.ffn_dim,
                           cfg.conv_kernel_size, cfg.dropout, dtype, attention)
            for _ in range(cfg.num_layers))
        self.out_proj = Dense(cfg.d_model, cfg.output_dim, dtype=dtype)
        self.mask_embedding = _param(cfg.d_model) if mask_embedding else None
        self.rows, self.parts = (0, 1), 1

    def forward(self, waveform, sample_mask=None, generator=None, mask_spans=None):
        """``waveform [B, S]`` f32; ``sample_mask [B, S]`` bool, True on valid
        samples (None: all valid); ``generator``: train mode, dropout and
        SpecAugment drawn from it (None: eval); ``mask_spans [B, T_enc]``
        bool: masked positions take ``mask_embedding`` after the subsampler,
        and the f32 detached latents there come back as ``ssl_targets``."""
        cfg, fe, dt = self.config, self.frontend, self.dtype
        B, S = waveform.shape
        # K1 on a CUDA tensor, its plain version on a CPU tensor.
        mel = log_mel_spectrogram_cuda(
            waveform.to(torch.float32).contiguous(), fe.sample_rate, fe.n_fft,
            fe.hop_length, fe.win_length, fe.n_mels, fe.f_min, fe.f_max,
            fe.log_eps, fe.center).detach()                         # [B, T_mel, n_mels]
        T_mel = mel.shape[1]
        if sample_mask is None:
            frame_valid = torch.ones(B, T_mel, dtype=torch.bool, device=mel.device)
        else:
            anchors = torch.clamp(
                torch.arange(T_mel, device=mel.device) * fe.hop_length, max=S - 1)
            frame_valid = sample_mask.index_select(1, anchors)
        if generator is not None and (cfg.specaug_freq_masks > 0 or cfg.specaug_time_masks > 0):
            mel = spec_augment(generator, mel, frame_valid,
                               freq_masks=cfg.specaug_freq_masks,
                               freq_mask_width=cfg.specaug_freq_width,
                               time_masks=cfg.specaug_time_masks,
                               time_mask_frac=cfg.specaug_time_frac,
                               rows=self.rows, parts=self.parts)

        f = cfg.subsample_factor
        x = conv1d_same(mel.to(dt), self.subsample_weight.to(dt),
                        self.subsample_bias.to(dt), stride=f)
        x = F.silu(x)
        T_enc = x.shape[1]
        frame_valid = frame_valid[:, ::f][:, :T_enc]

        ssl_targets = None
        if mask_spans is not None:
            if self.mask_embedding is None:
                raise ValueError("mask_spans needs an encoder built with mask_embedding=True")
            ssl_targets = x.to(torch.float32).detach()
            x = torch.where(mask_spans[..., None], self.mask_embedding.to(dt), x)

        x = x + sinusoidal_positions(T_enc, cfg.d_model, x.device).to(dt)[None]
        attn_mask = frame_valid[:, None, None, :] & frame_valid[:, None, :, None]
        hiddens = []
        for block in self.blocks:
            x = block(x, frame_valid, attn_mask, generator)
            hiddens.append(x)
        middle = torch.stack([hiddens[i] for i in cfg.middle_layers]).mean(dim=0)
        if ssl_targets is None:
            return self.out_proj(x), middle, frame_valid
        return self.out_proj(x), middle, frame_valid, ssl_targets

    @staticmethod
    def output_length(cfg: AudioEncoderConfig, fe: AudioFrontendConfig, n_samples: int) -> int:
        """Encoder frames for ``n_samples`` input samples (``audio.py:219-223``)."""
        t_mel = num_frames(n_samples, fe.n_fft, fe.hop_length, fe.center)
        return -(-t_mel // cfg.subsample_factor)
