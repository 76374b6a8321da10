"""AV-HuBERT fine-tuned with CTC: an early-fusion audio-visual transformer
(``model.arch = "avhubert"``).

Written from facebookresearch/av_hubert (``avhubert/hubert.py``
``AVHubertModel.extract_finetune``, ``SubModel``; ``avhubert/resnet.py``
``ResEncoder``; ``avhubert/hubert_asr.py``'s CTC head; the encoder is
fairseq's wav2vec 2.0 ``TransformerEncoder``) and arXiv:2201.02184.  Lengths
count video frames.  The two speakers run as one ``[2B]`` batch: each row is
one speaker's lips with the shared mixture, whose filterbank is computed once
(K1 on ``[B, S]``) and used by both of its rows.

* audio front end: K1's log filterbank (``config.frontend``: 26 bins,
  ``center=False``) of the bucket-padded mixture, whose frames that run past
  the mixture's last sample become zero rows (so a mixture gives the features
  it gives alone: AV-HuBERT filterbanks each utterance by itself), zero
  frames to a multiple of ``STACK`` (4), that many frames stacked into one
  video frame (``[T, 4 * 26]``), cut or zero-padded
  to the video's frames, normalised per row over its valid frames (mean and
  biased variance of the whole valid ``[T, 104]`` block, eps 1e-5, no
  affine: ``F.layer_norm`` over the utterance, as AV-HuBERT's data loader
  does it), then ``Linear(104 -> embed_dim)``;
* visual front end: the port's ``VisualEncoder`` (time-folded 5-tap
  frontend, ResNet-18 with BatchNorm and PReLU, global mean), whose
  ``Linear(512 -> embed_dim)`` is AV-HuBERT's video projection;
* fusion: ``[audio, video]`` concatenated, ``LayerNorm(2 embed_dim)``,
  ``Linear(2 embed_dim -> embed_dim)``; padded frames zeroed, then the
  positional convolution: ``Conv1d(k = conv_pos, groups = conv_pos_groups,
  pad = k / 2)`` under weight norm over dim 2 (``w = g v / |v|``, the norm of
  each kernel tap over output and input channels; ``g`` is stored ``[k]``,
  published ``[1, 1, k]``), the last output frame dropped (SamePad for an
  even kernel), exact GELU, added to x;
* ``num_layers`` pre-LN layers: ``x += MHA(LN(x))`` with a key-padding mask,
  ``x += fc2(GELU(fc1(LN(x))))`` with exact GELU; a final LayerNorm; LayerNorm
  eps ``EPS`` (1e-5) throughout;
* CTC head: ``Linear(embed_dim -> V)``, log-softmax.

Train mode: BatchNorm batch statistics over the ``[2B]`` rows, and dropout
(``config.avhubert``) drawn from the generator at fairseq's sites, except that
the attention weights share one ``[Tq, Tk]`` mask over rows and heads (the
port's ``MultiHeadAttention``; fairseq draws each element).  Not
implemented: LayerDrop, modality dropout, the dropout on the projected
features and before the head (pretraining and regularisation devices).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..data.mixing import MASK_PAD
from ..ops.logmel import log_mel_spectrogram_cuda
from ..ops.lstm_scan import length_mask
from ..tracing import span
from .av_model import nchw_clip_to_channels_last
from .decoder import CTCDecoder
from .layers import Dense, LayerNorm, MultiHeadAttention, _param, dropout
from .visual import VisualEncoder

STACK = 4      # filterbank frames (10 ms) in one video frame (40 ms, 25 fps)
EPS = 1e-5     # every LayerNorm's and the utterance normalisation's (fairseq's)


def stack_frames(feats: torch.Tensor, order: int) -> torch.Tensor:
    """``[B, T, F] -> [B, ceil(T / order), order * F]``: zero frames to a
    multiple of ``order``, then ``order`` neighbouring frames side by side
    (AV-HuBERT's ``stacker``)."""
    B, T, Fd = feats.shape
    feats = F.pad(feats, (0, 0, 0, (-T) % order))
    return feats.reshape(B, -1, order * Fd)


def fit_frames(x: torch.Tensor, T: int) -> torch.Tensor:
    """``[B, T', F] -> [B, T, F]``: cut, or zero frames appended."""
    return x[:, :T] if x.shape[1] >= T else F.pad(x, (0, 0, 0, T - x.shape[1]))


def masked_utterance_norm(x: torch.Tensor, valid: torch.Tensor, eps: float = EPS):
    """Each row of ``x [R, T, F]`` normalised by the mean and biased variance
    of its valid frames' ``T_valid * F`` features (``valid [R, T]`` bool),
    in f32; frames past them come out 0."""
    x = x.float()
    m = valid[..., None].to(x.dtype)
    n = (m.sum(dim=(1, 2)) * x.shape[-1]).clamp(min=1.0)
    mean = (x * m).sum(dim=(1, 2)) / n
    d = (x - mean[:, None, None]) * m
    var = (d * d).sum(dim=(1, 2)) / n
    return d * torch.rsqrt(var + eps)[:, None, None]


class StackedFilterbank(nn.Module):
    """The audio front end: K1, stacking, per-row normalisation, projection."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.frontend = config.frontend
        self.proj = Dense(STACK * config.frontend.n_mels, config.avhubert.embed_dim,
                          dtype=dtype)

    def forward(self, audio: torch.Tensor, samples: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        """``audio [B, S]`` mixtures of ``samples [B]`` samples each, ``valid
        [2B, T_v]`` -> ``[2B, T_v, D]``: row ``r`` reads mixture ``r mod B``."""
        fe = self.frontend
        fbank = log_mel_spectrogram_cuda(
            audio.to(torch.float32).contiguous(), fe.sample_rate, fe.n_fft, fe.hop_length,
            fe.win_length, fe.n_mels, fe.f_min, fe.f_max, fe.log_eps, fe.center).detach()
        # The frames a mixture of `samples` samples has alone (ops/logmel.num_frames).
        n = samples.to(torch.int64) + (fe.n_fft if fe.center else 0)
        frames = torch.where(n >= fe.n_fft, 1 + (n - fe.n_fft) // fe.hop_length, 0)
        keep = torch.arange(fbank.shape[1], device=fbank.device)[None] < frames[:, None]
        fbank = torch.where(keep[..., None], fbank, 0.0)
        feats = fit_frames(stack_frames(fbank, STACK), valid.shape[1])
        feats = masked_utterance_norm(torch.cat([feats, feats]), valid)
        return self.proj(feats)


class PositionalConv(nn.Module):
    """fairseq's ``pos_conv``: a grouped, weight-normed convolution over
    time with SamePad and exact GELU, whose output the caller adds to x."""

    def __init__(self, dim: int, kernel: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.weight_v = _param(dim, dim // groups, kernel)
        self.weight_g = _param(kernel)
        self.bias = _param(dim)
        self.groups, self.dtype = groups, dtype

    def weight(self) -> torch.Tensor:
        """``g v / |v|``, the norm of each tap over dims 0 and 1 (f32)."""
        v = self.weight_v
        return v * (self.weight_g / torch.linalg.vector_norm(v, dim=(0, 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x [B, T, D]`` (padded frames already 0) -> ``[B, T, D]``."""
        dt = self.dtype
        k = self.weight_v.shape[-1]
        h = F.conv1d(x.to(dt).transpose(1, 2), self.weight().to(dt), self.bias.to(dt),
                     padding=k // 2, groups=self.groups)
        if k % 2 == 0:
            h = h[..., :-1]
        return F.gelu(h.transpose(1, 2))


class EarlyFusion(nn.Module):
    """Concatenation, LayerNorm and projection of the two modalities, then
    the positional convolution added to the zero-padded result."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype):
        super().__init__()
        a = config.avhubert
        D = a.embed_dim
        self.norm = LayerNorm(2 * D, dtype, eps=EPS)
        self.proj = Dense(2 * D, D, dtype=dtype)
        self.pos_conv = PositionalConv(D, a.conv_pos, a.conv_pos_groups, dtype)

    def forward(self, audio: torch.Tensor, video: torch.Tensor, valid: torch.Tensor):
        x = self.proj(self.norm(torch.cat([audio, video.to(audio.dtype)], dim=-1)))
        x = torch.where(valid[..., None], x, 0.0)
        return x + self.pos_conv(x)


class EncoderLayer(nn.Module):
    """One pre-LN transformer layer (fairseq's ``TransformerSentenceEncoderLayer``
    with ``layer_norm_first``)."""

    def __init__(self, config, dtype: torch.dtype):
        super().__init__()
        D = config.embed_dim
        self.attn_norm = LayerNorm(D, dtype, eps=EPS)
        self.attn = MultiHeadAttention(D, config.num_heads, dtype, config.attention_dropout)
        self.ffn_norm = LayerNorm(D, dtype, eps=EPS)
        self.fc1 = Dense(D, config.ffn_dim, dtype=dtype)
        self.fc2 = Dense(config.ffn_dim, D, dtype=dtype)
        self.rate, self.act_rate = config.dropout, config.activation_dropout

    def forward(self, x, mask, generator=None):
        h = self.attn_norm(x)
        x = x + dropout(self.attn(h, h, mask, generator), self.rate, generator)
        h = dropout(F.gelu(self.fc1(self.ffn_norm(x))), self.act_rate, generator)
        return x + dropout(self.fc2(h), self.rate, generator)


class TransformerStack(nn.Module):
    """The encoder's layers and its final LayerNorm."""

    def __init__(self, config, dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(config, dtype) for _ in range(config.num_layers))
        self.final_norm = LayerNorm(config.embed_dim, dtype, eps=EPS)
        self.rate = config.dropout

    def forward(self, x, valid, generator=None):
        x = dropout(x, self.rate, generator)
        mask = valid[:, None, None, :]
        for layer in self.layers:
            x = layer(x, mask, generator)
        return self.final_norm(x)


class AVHubertCTC(nn.Module):
    """AV-HuBERT with a CTC head on the two-speaker batch, called as
    ``MultiSpeakerAVModel`` is.  Spans (``tracing``): ``encoders.visual``,
    ``encoders.audio`` (K1, stacking, normalisation, projection),
    ``fusion`` (concatenation, LayerNorm, projection, positional
    convolution), ``encoders.layers`` (the transformer layers) and
    ``decoder``."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        a = config.avhubert
        if config.visual.output_dim != a.embed_dim:
            raise ValueError(f"model.visual.output_dim={config.visual.output_dim} must be "
                             f"model.avhubert.embed_dim={a.embed_dim}: the trunk's projection "
                             "is AV-HuBERT's video projection")
        if a.conv_pos_groups < 1 or a.embed_dim % a.conv_pos_groups:
            raise ValueError(f"embed_dim {a.embed_dim} not divisible by conv_pos_groups "
                             f"{a.conv_pos_groups}")
        self.config, self.dtype = config, dtype
        self.visual_encoder = VisualEncoder(config.visual, dtype)
        self.audio_frontend = StackedFilterbank(config, dtype)
        self.fusion = EarlyFusion(config, dtype)
        self.encoder = TransformerStack(a, dtype)
        self.decoder = CTCDecoder(config.decoder, a.embed_dim, dtype)

    def forward(self, lip1, lip2, audio, mask1=None, mask2=None, lip1_len=None, lip2_len=None,
                train: bool = False, stop_visual_grad: bool = False, generator=None):
        """Collate layouts: lips ``[B, T, 1, H, W]``, audio ``[B, S]``; of the
        speaker masks only the padding is read, for the mixture's length (None:
        every sample; AV-HuBERT takes no speaker mask).
        Returns ``log_probs{1,2} [B, T, V]`` and ``input_lengths{1,2} [B]``,
        each speaker's lip frames.  ``train``, ``stop_visual_grad`` and
        ``generator`` as ``MultiSpeakerAVModel.forward``'s."""
        a = self.config.avhubert
        rates = (a.dropout, a.attention_dropout, a.activation_dropout)
        if train and generator is None and any(r > 0 for r in rates):
            raise ValueError("train mode with dropout needs a dropout generator")
        B, T = lip1.shape[0], lip1.shape[1]
        full = torch.full((B,), T, dtype=torch.int32, device=lip1.device)
        lens = torch.cat([full if lip1_len is None else lip1_len.to(torch.int32),
                          full if lip2_len is None else lip2_len.to(torch.int32)])
        valid = length_mask(lens, T)
        gen = generator if train else None
        lips = torch.cat([nchw_clip_to_channels_last(lip1), nchw_clip_to_channels_last(lip2)])
        with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_visual_grad), \
                span("encoders.visual"):
            v = self.visual_encoder(lips, train)
        samples = (torch.full((B,), audio.shape[1], device=audio.device) if mask1 is None
                   else (mask1 != MASK_PAD).sum(dim=1))
        with span("encoders.audio"):
            x = self.audio_frontend(audio, samples, valid)
        with span("fusion"):
            x = self.fusion(x, v, valid)
        with span("encoders.layers"):
            x = self.encoder(x, valid, gen)
        with span("decoder"):
            log_probs = self.decoder(x)
        return {"log_probs1": log_probs[:B], "input_lengths1": lens[:B],
                "log_probs2": log_probs[B:], "input_lengths2": lens[B:]}
