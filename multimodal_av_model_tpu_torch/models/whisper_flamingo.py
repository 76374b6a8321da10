"""Whisper-Flamingo: Whisper's encoder and decoder with the lips let in by
Flamingo's gated cross-attention (``model.arch = "whisper_flamingo"``).

Written from github.com/roudimit/whisper-flamingo and arXiv:2406.10082, on
Whisper (openai/whisper ``whisper/model.py``, ``whisper/audio.py``;
arXiv:2212.04356) and Flamingo's gated blocks (arXiv:2204.14198).  The two
speakers run as ``[2B]`` decoder rows (row ``r`` is speaker ``r // B``'s lips
with mixture ``r mod B``); the mixture is encoded once, on its ``B`` rows.

* audio: the mixture padded or cut to ``2 n_audio_ctx`` hops (30 s); K1's mel
  power over ``frontend``'s bins (Whisper: 80 Slaney bins, centred), its
  last frame dropped, then Whisper's epilogue (``ops/logmel.whisper_log_mel``:
  ``log10``, the utterance's ``max - 8`` floor, ``(L + 4) / 4``), in f32;
* audio encoder: ``GELU(Conv1d(n_mels -> D, k 3, pad 1))``, ``GELU(Conv1d(D
  -> D, k 3, stride 2, pad 1))``, plus Whisper's ``sinusoids`` table (sin in
  the first half of the channels, cos in the second; not the interleaved
  ``layers.sinusoidal_positions``); pre-LN blocks ``x += MHA(LN(x))``,
  ``x += fc2(GELU(fc1(LN(x))))`` with exact GELU and no mask; a final LN;
* video encoder: AV-HuBERT on video alone, from ``models/avhubert.py``'s
  modules: the ResNet-18 trunk with its ``Linear(512 -> video_dim)``, the
  fusion over ``[zeros, video]`` (as AV-HuBERT fills a missing audio stream),
  the positional convolution, the layers and their final LN; then
  ``video_proj``, ``Linear(video_dim -> n_text_state)``;
* decoder: ``x = E[y] + P[:n]``; each layer ``x += tanh(a_a) MHA_g(LN(x),
  video)`` with the padded video frames masked, ``x += tanh(a_f)
  FF_g(LN(x))`` (the gated block, ``GatedCrossAttention``), ``x +=
  MHA(LN(x))`` causal, ``x += MHA(LN(x), audio)``, ``x += FF(LN(x))``; logits
  ``LN(x) E^T`` in f32.  The cross-attention's keys and values are computed
  on the ``B`` mixtures: each mixture's two decoder rows query them as one
  row of ``2 n`` queries.

Every attention's key projection has no bias (Whisper's); LayerNorm eps is
1e-5.  Compute is in ``dtype`` over f32 parameters; LayerNorm statistics,
the log-mel and the logits are f32.  Only the modules of ``TRAINABLE`` (the
gated blocks and the video projection: Flamingo's rule, arXiv:2204.14198
section 3) train: the others are built with ``requires_grad`` off, and both encoders
run in eval mode (BatchNorm on its running statistics) under
``torch.no_grad``, so no autograd graph is kept for them.  The decoder's
frozen layers still pass the gradient back to the gated blocks below them.
No dropout.  ``pipeline_options`` gives the data pipeline Whisper's window
and the decoder's rows.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..data.device_pipeline import whisper_labels
from ..ops.logmel import log_mel_spectrogram_cuda, whisper_log_mel
from ..ops.lstm_scan import length_mask
from ..tracing import count, span
from .av_model import nchw_clip_to_channels_last
from .avhubert import EarlyFusion, TransformerStack
from .layers import Dense, LayerNorm, MultiHeadAttention, _param
from .visual import VisualEncoder

EPS = 1e-5          # Whisper's LayerNorm eps
TRAINABLE = ("gated", "video_proj")     # the modules that train; the rest is frozen


def pipeline_options(config: ModelConfig) -> dict:
    """``data/device_pipeline.device_preprocessed_batches``' options for
    Whisper-Flamingo: the mixture padded or cut to Whisper's window of ``2
    n_audio_ctx`` hops, and each speaker's decoder input ids and targets
    (``whisper_labels``) built from the raw batch's labels."""
    w = config.whisper_flamingo

    def decoder_rows(raw: dict) -> dict:
        rows = {}
        for s in "12":
            rows["tokens" + s], rows["targets" + s] = whisper_labels(
                raw["text" + s], raw[f"text{s}_lengths"], w.prompt, w.eot)
        if rows["tokens1"].shape[1] > w.n_text_ctx:
            raise ValueError(f"{rows['tokens1'].shape[1]} decoder positions (the prompt and "
                             f"the label bucket); Whisper has {w.n_text_ctx}")
        return rows

    return {"window": 2 * w.n_audio_ctx * config.frontend.hop_length,
            "decoder_rows": decoder_rows}


@functools.lru_cache(maxsize=8)
def whisper_sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's ``sinusoids(length, channels)`` ``[length, channels]`` f32:
    ``sin(t w_i)`` in channels ``i < channels / 2`` and ``cos(t w_i)`` in the
    rest, ``w_i = exp(-ln(10^4) i / (channels / 2 - 1))``."""
    half = channels // 2
    inv = torch.exp(-math.log(10000.0) / (half - 1)
                    * torch.arange(half, dtype=torch.float32, device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def pad_or_trim(audio: torch.Tensor, samples: int) -> torch.Tensor:
    """``[B, S] -> [B, samples]``: cut, or zeros appended (Whisper's
    ``pad_or_trim``)."""
    S = audio.shape[-1]
    return audio[..., :samples] if S >= samples else F.pad(audio, (0, samples - S))


class Conv1d(nn.Module):
    """A 1-D convolution with f32 parameters, computed in ``dtype`` on
    ``[B, C, T]``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, padding: int,
                 dtype: torch.dtype):
        super().__init__()
        self.weight = _param(out_ch, in_ch, kernel)
        self.bias = _param(out_ch)
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        dt = self.dtype
        return F.conv1d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride,
                        self.padding)


class MLP(nn.Module):
    """``fc2(GELU(fc1(x)))``, exact GELU, width ``4 dim``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(dim, 4 * dim, dtype=dtype)
        self.fc2 = Dense(4 * dim, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def attention(dim: int, heads: int, dtype: torch.dtype) -> MultiHeadAttention:
    """Whisper's attention: biases on the query, value and output, none on the key."""
    return MultiHeadAttention(dim, heads, dtype, key_bias=False)


def over_memory(attn: MultiHeadAttention, x: torch.Tensor, memory: torch.Tensor):
    """``attn`` of the ``[k B, n, D]`` rows ``x`` over the ``[B, T, D]``
    ``memory`` that row ``r`` reads as ``memory[r mod B]``: the ``k`` rows of
    one memory row query it as one row of ``k n`` queries, so its keys and
    values are computed once."""
    R, n, D = x.shape
    B = memory.shape[0]
    k = R // B
    q = x.view(k, B, n, D).transpose(0, 1).reshape(B, k * n, D)
    out = attn(q, memory)
    return out.view(B, k, n, D).transpose(0, 1).reshape(R, n, D)


class EncoderBlock(nn.Module):
    """Whisper's ``ResidualAttentionBlock`` of the audio encoder."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.attn_ln = LayerNorm(dim, dtype, eps=EPS)
        self.attn = attention(dim, heads, dtype)
        self.mlp_ln = LayerNorm(dim, dtype, eps=EPS)
        self.mlp = MLP(dim, dtype)

    def forward(self, x):
        h = self.attn_ln(x)
        x = x + self.attn(h, h)
        return x + self.mlp(self.mlp_ln(x))


class WhisperAudioEncoder(nn.Module):
    """Mixture ``[B, S]`` -> ``[B, n_audio_ctx, n_audio_state]``: K1 and
    Whisper's epilogue, the two convolutions, the sinusoids, the blocks and
    ``ln_post``."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype):
        super().__init__()
        w, fe = config.whisper_flamingo, config.frontend
        D = w.n_audio_state
        self.frontend, self.n_ctx, self.dtype = fe, w.n_audio_ctx, dtype
        self.conv1 = Conv1d(fe.n_mels, D, 3, 1, 1, dtype)
        self.conv2 = Conv1d(D, D, 3, 2, 1, dtype)
        self.blocks = nn.ModuleList(EncoderBlock(D, w.n_audio_head, dtype)
                                    for _ in range(w.n_audio_layer))
        self.ln_post = LayerNorm(D, dtype, eps=EPS)

    def features(self, audio: torch.Tensor) -> torch.Tensor:
        """``[B, S]`` -> Whisper's log-mel ``[B, 2 n_audio_ctx, n_mels]`` (f32)."""
        fe = self.frontend
        frames = 2 * self.n_ctx
        audio = pad_or_trim(audio.to(torch.float32), frames * fe.hop_length).contiguous()
        mel = log_mel_spectrogram_cuda(audio, fe.sample_rate, fe.n_fft, fe.hop_length,
                                       fe.win_length, fe.n_mels, fe.f_min, fe.f_max,
                                       fe.log_eps, fe.center, apply_log=False,
                                       mel_scale=fe.mel_scale)
        return whisper_log_mel(mel, frames)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        x = self.features(audio).transpose(1, 2)
        x = F.gelu(self.conv1(x))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        pe = whisper_sinusoids(x.shape[1], x.shape[2], x.device)
        x = (x.float() + pe).to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.ln_post(x)


class VideoEncoder(nn.Module):
    """AV-HuBERT's encoder on video alone: lips ``[R, T, H, W, 1]`` (channels
    last), ``valid [R, T]`` -> ``[R, T, video_dim]``."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype):
        super().__init__()
        a = config.avhubert
        if config.visual.output_dim != a.embed_dim:
            raise ValueError(f"model.visual.output_dim={config.visual.output_dim} must be "
                             f"model.avhubert.embed_dim={a.embed_dim}")
        if any((a.dropout, a.attention_dropout, a.activation_dropout)):
            raise ValueError("the frozen video encoder runs in eval mode: set "
                             "model.avhubert's dropout rates to 0")
        self.visual_encoder = VisualEncoder(config.visual, dtype)
        self.fusion = EarlyFusion(config, dtype)
        self.encoder = TransformerStack(a, dtype)

    def forward(self, lips: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        v = self.visual_encoder(lips, False)
        x = self.fusion(torch.zeros_like(v), v, valid)
        return self.encoder(x, valid)


class GatedCrossAttention(nn.Module):
    """Flamingo's gated block: ``x += tanh(attn_gate) MHA(LN(x), video)``,
    ``x += tanh(ff_gate) FF(LN(x))``.  Span: ``decoder.xattn``."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.attn_ln = LayerNorm(dim, dtype, eps=EPS)
        self.attn = attention(dim, heads, dtype)
        self.attn_gate = _param(1)
        self.ff_ln = LayerNorm(dim, dtype, eps=EPS)
        self.ff = MLP(dim, dtype)
        self.ff_gate = _param(1)

    def forward(self, x, video, mask):
        with span("decoder.xattn"):
            dt = x.dtype
            x = x + torch.tanh(self.attn_gate).to(dt) * self.attn(self.attn_ln(x), video, mask)
            return x + torch.tanh(self.ff_gate).to(dt) * self.ff(self.ff_ln(x))


class DecoderBlock(nn.Module):
    """Whisper's decoder ``ResidualAttentionBlock``: causal self-attention,
    cross-attention over the audio, MLP."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.attn_ln = LayerNorm(dim, dtype, eps=EPS)
        self.attn = attention(dim, heads, dtype)
        self.cross_attn_ln = LayerNorm(dim, dtype, eps=EPS)
        self.cross_attn = attention(dim, heads, dtype)
        self.mlp_ln = LayerNorm(dim, dtype, eps=EPS)
        self.mlp = MLP(dim, dtype)

    def forward(self, x, audio):
        h = self.attn_ln(x)
        x = x + self.attn(h, h, causal=True)
        x = x + over_memory(self.cross_attn, self.cross_attn_ln(x), audio)
        return x + self.mlp(self.mlp_ln(x))


class WhisperTextDecoder(nn.Module):
    """Whisper's ``TextDecoder`` with a gated block (given to ``forward``)
    before each layer.  Span: ``decoder``."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype):
        super().__init__()
        w = config.whisper_flamingo
        D = w.n_text_state
        self.token_embedding = _param(w.n_vocab, D)
        self.positional_embedding = _param(w.n_text_ctx, D)
        self.blocks = nn.ModuleList(DecoderBlock(D, w.n_text_head, dtype)
                                    for _ in range(w.n_text_layer))
        self.ln = LayerNorm(D, torch.float32, eps=EPS)
        self.dtype = dtype

    def forward(self, tokens, audio, video, video_valid, gated):
        """``tokens [R, n]``, ``audio [B, T_a, D]`` (``R`` a multiple of
        ``B``), ``video [R, T_v, D]`` with ``video_valid [R, T_v]`` ->
        logits ``[R, n, n_vocab]`` f32."""
        n = tokens.shape[1]
        if n > self.positional_embedding.shape[0]:
            raise ValueError(f"{n} decoder positions; Whisper has "
                             f"{self.positional_embedding.shape[0]}")
        x = (self.token_embedding[tokens] + self.positional_embedding[:n]).to(self.dtype)
        mask = video_valid[:, None, None, :]
        for gate, block in zip(gated, self.blocks):
            x = block(gate(x, video, mask), audio)
        return F.linear(self.ln(x), self.token_embedding)


class WhisperFlamingo(nn.Module):
    """Whisper-Flamingo on the two-speaker batch, called as
    ``MultiSpeakerAVModel`` is, with each speaker's decoder input ids.
    Spans (``tracing``): ``encoders.audio`` (K1, the epilogue, the Whisper
    encoder), ``encoders.visual`` (the video encoder), ``decoder`` (the
    video projection and the decoder, ``decoder.xattn`` in it); each frozen
    encoder's pass counts ``frozen_forward``."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        w = config.whisper_flamingo
        if w.n_audio_state != w.n_text_state:
            raise ValueError("the decoder's cross-attention reads the audio encoder's width: "
                             f"n_audio_state {w.n_audio_state} != n_text_state "
                             f"{w.n_text_state}")
        if config.avhubert.embed_dim != w.video_dim:
            raise ValueError(f"model.avhubert.embed_dim={config.avhubert.embed_dim} must be "
                             f"model.whisper_flamingo.video_dim={w.video_dim}")
        self.config, self.dtype = config, dtype
        self.audio_encoder = WhisperAudioEncoder(config, dtype)
        self.video_encoder = VideoEncoder(config, dtype)
        self.video_proj = Dense(w.video_dim, w.n_text_state, dtype=dtype)
        self.gated = nn.ModuleList(GatedCrossAttention(w.n_text_state, w.n_text_head, dtype)
                                   for _ in range(w.n_text_layer))
        self.decoder = WhisperTextDecoder(config, dtype)
        # The trainer leaves these out of the optimizer (``label_params``).
        self.frozen_prefixes = tuple(f"{n}." for n, _ in self.named_children()
                                     if n not in TRAINABLE)
        for name, module in self.named_children():
            if name not in TRAINABLE:
                module.requires_grad_(False)

    def project_video(self, video: torch.Tensor) -> torch.Tensor:
        return self.video_proj(video)

    def forward(self, lip1, lip2, audio, mask1=None, mask2=None, lip1_len=None, lip2_len=None,
                train: bool = False, stop_visual_grad: bool = False, generator=None,
                tokens1=None, tokens2=None):
        """Collate layouts: lips ``[B, T, 1, H, W]``, audio ``[B, S]`` (the
        speaker masks are not read: Whisper hears the whole mixture);
        ``tokens{1,2} [B, n]`` each speaker's decoder input ids.  Returns
        ``logits{1,2} [B, n, n_vocab]`` f32 and ``video_lengths{1,2}``.  The
        model has no train-mode behaviour, so ``train``, ``stop_visual_grad``
        and ``generator`` change nothing."""
        if tokens1 is None or tokens2 is None:
            raise ValueError("Whisper-Flamingo's forward needs each speaker's decoder input "
                             "ids (pipeline_options)")
        B, T = lip1.shape[0], lip1.shape[1]
        full = torch.full((B,), T, dtype=torch.int32, device=lip1.device)
        lens = torch.cat([full if lip1_len is None else lip1_len.to(torch.int32),
                          full if lip2_len is None else lip2_len.to(torch.int32)])
        valid = length_mask(lens, T)
        with torch.no_grad():
            with span("encoders.audio"):
                memory = self.audio_encoder(audio)
                count("frozen_forward")
            with span("encoders.visual"):
                lips = torch.cat([nchw_clip_to_channels_last(lip1),
                                  nchw_clip_to_channels_last(lip2)])
                video = self.video_encoder(lips, valid)
                count("frozen_forward")
        with span("decoder"):
            logits = self.decoder(torch.cat([tokens1, tokens2]), memory,
                                  self.project_video(video), valid, self.gated)
        return {"logits1": logits[:B], "video_lengths1": lens[:B],
                "logits2": logits[B:], "video_lengths2": lens[B:]}
