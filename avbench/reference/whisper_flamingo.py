"""Whisper-Flamingo as plain functions of a flat state dict.

Equations (github.com/roudimit/whisper-flamingo, arXiv:2406.10082; Whisper's
``whisper/model.py`` and ``whisper/audio.py``, arXiv:2212.04356; Flamingo's
gated cross-attention, arXiv:2204.14198), every product in float32, or on
float8 inputs under ``lowp``; row ``r`` of the ``[2B]`` decoder batch is
speaker ``r // B``'s lips with mixture ``r mod B``:

* audio: the mixture zero-padded or cut to ``2 n_audio_ctx`` hops (480,000
  samples); ``|STFT|^2`` (``torch.stft``: n_fft, hop, periodic Hann, centred
  with reflect padding), its last frame dropped; times the Slaney filterbank
  (``slaney_filterbank``, librosa's ``filters.mel(htk=False,
  norm="slaney")``, written from its formula); ``L = log10(max(mel,
  1e-10))``, ``L = max(L, max(L) - 8)`` with the max over the utterance,
  ``(L + 4) / 4``;
* audio encoder: ``GELU(conv1)``, ``GELU(conv2)`` (stride 2), plus
  ``sinusoids`` (sin in the first half of the channels, cos in the second),
  pre-LN blocks ``x += MHA(LN(x))``, ``x += W2 GELU(W1 LN(x))`` (exact GELU,
  no mask), a final LN;
* video encoder: ``avhubert.AVHubertNet`` on the ``video_encoder.`` entries,
  in eval mode: the ResNet-18 trunk with its projection, ``LN([0, v])``, the
  fusion's projection, the positional convolution, the layers and their LN;
  then ``video_proj``;
* decoder: ``x = E[y] + P[:n]``; per layer ``x += tanh(a_a) MHA(LN(x),
  video)`` (padded frames masked), ``x += tanh(a_f) FF(LN(x))``, ``x +=
  MHA(LN(x))`` causal, ``x += MHA(LN(x), audio)``, ``x += FF(LN(x))``;
  logits ``LN(x) E^T``;
* every key projection without bias, LayerNorm eps 1e-5.

Loss: per row, the mean cross-entropy over its target positions (text and
eot; the prompt is none), averaged over the rows of each speaker, the two
speakers averaged.  The encoders run without autograd; the gradients are of
the gated blocks and the video projection alone.  With ``checkpoint`` the
decoder's layers are recomputed in the backward, so the published widths
fit in float32.  No dropout.  Departures from the published model are the
configuration's ``assumed``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .avhubert import AVHubertNet

VIDEO = "video_encoder."


def slaney_mel(f):
    f = np.asarray(f, np.float64)
    logstep = math.log(6.4) / 27.0
    return np.where(f < 1000.0, 3.0 * f / 200.0,
                    15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep)


def slaney_hz(m):
    m = np.asarray(m, np.float64)
    logstep = math.log(6.4) / 27.0
    return np.where(m < 15.0, 200.0 * m / 3.0, 1000.0 * np.exp(logstep * (m - 15.0)))


def slaney_filterbank(n_fft: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """``[n_fft // 2 + 1, n_mels]``: filter ``m`` rises from point ``m`` to
    ``m + 1`` and falls to ``m + 2`` of ``n_mels + 2`` points evenly spaced on
    the Slaney scale over ``[0, sample_rate / 2]``, times ``2 / (f_{m+2} -
    f_m)``."""
    freqs = np.arange(n_fft // 2 + 1) * sample_rate / n_fft
    f = slaney_hz(np.linspace(0.0, slaney_mel(sample_rate / 2), n_mels + 2))
    fb = np.zeros((len(freqs), n_mels))
    for m in range(n_mels):
        rise = (freqs - f[m]) / (f[m + 1] - f[m])
        fall = (f[m + 2] - freqs) / (f[m + 2] - f[m + 1])
        fb[:, m] = np.clip(np.minimum(rise, fall), 0.0, None) * 2.0 / (f[m + 2] - f[m])
    return fb


def log_mel(mixture: torch.Tensor, cfg: dict) -> torch.Tensor:
    """``[B, S]`` mixtures -> Whisper's features ``[B, 2 n_audio_ctx, n_mels]``."""
    fe, w = cfg["frontend"], cfg["whisper_flamingo"]
    frames = 2 * w["n_audio_ctx"]
    samples = frames * fe["hop_length"]
    x = mixture.to(torch.float32)
    x = x[:, :samples] if x.shape[1] >= samples else F.pad(x, (0, samples - x.shape[1]))
    window = torch.hann_window(fe["n_fft"], periodic=True, device=x.device)
    spec = torch.stft(x, fe["n_fft"], fe["hop_length"], window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec[..., :-1].abs() ** 2                               # [B, F, frames]
    fb = torch.from_numpy(slaney_filterbank(fe["n_fft"], fe["n_mels"],
                                            fe["sample_rate"])).to(power)
    L = torch.clamp(fb.T @ power, min=1e-10).log10()
    L = torch.maximum(L, L.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((L + 4.0) / 4.0).transpose(1, 2)


def sinusoids(length: int, channels: int, device) -> torch.Tensor:
    step = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-step * torch.arange(channels // 2, device=device, dtype=torch.float32))
    t = torch.arange(length, device=device, dtype=torch.float32)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


class WhisperFlamingoNet(AVHubertNet):
    """``P``: name -> tensor (the system's state-dict names); ``cfg``: the
    configuration file's ``model`` dict; ``lowp``: float8 operands;
    ``checkpoint``: recompute the decoder's layers in the backward."""

    def __init__(self, P: dict, cfg: dict, lowp: bool = False, checkpoint: bool = False):
        super().__init__(P, cfg, train=False, lowp=lowp)
        self.video_net = AVHubertNet({k[len(VIDEO):]: v for k, v in P.items()
                                      if k.startswith(VIDEO)}, cfg, train=False, lowp=lowp)
        self.w, self.checkpoint = cfg["whisper_flamingo"], checkpoint

    def mlp(self, name, x):
        return self.dense(name + ".fc2", F.gelu(self.dense(name + ".fc1", x)))

    def audio(self, feats):
        """``[B, frames, n_mels]`` -> ``[B, n_audio_ctx, D]``."""
        P, w = self.P, self.w
        x = F.gelu(F.conv1d(self.q(feats.transpose(1, 2)), self.q(P["audio_encoder.conv1.weight"]),
                            P["audio_encoder.conv1.bias"], padding=1))
        x = F.gelu(F.conv1d(self.q(x), self.q(P["audio_encoder.conv2.weight"]),
                            P["audio_encoder.conv2.bias"], stride=2, padding=1)).transpose(1, 2)
        x = x + sinusoids(x.shape[1], x.shape[2], x.device)
        for i in range(w["n_audio_layer"]):
            n = f"audio_encoder.blocks.{i}"
            h = self.layer_norm(n + ".attn_ln", x)
            x = x + self.attention(n + ".attn", h, h, w["n_audio_head"])
            x = x + self.mlp(n + ".mlp", self.layer_norm(n + ".mlp_ln", x))
        return self.layer_norm("audio_encoder.ln_post", x)

    def video(self, lips, lengths):
        """``[R, T, 1, H, W]`` lips of ``lengths`` frames -> ``[R, T, video_dim]``."""
        net = self.video_net
        T = lips.shape[1]
        valid = torch.arange(T, device=lips.device)[None] < lengths[:, None]
        v = net.visual(lips)
        x = net.dense("fusion.proj", net.layer_norm("fusion.norm",
                                                    torch.cat([torch.zeros_like(v), v], -1)))
        x = torch.where(valid[..., None], x, 0.0)
        x = x + net.pos_conv(x)
        mask = valid[:, None, None, :]
        for i in range(self.cfg["avhubert"]["num_layers"]):
            x = net.layer(i, x, mask)
        return net.layer_norm("encoder.final_norm", x)

    def gated(self, i, x, video, vmask):
        """Gated block ``i``: ``x += tanh(a_a) MHA(LN(x), video)`` over the
        frames ``vmask`` keeps, ``x += tanh(a_f) FF(LN(x))``."""
        g, H = f"gated.{i}", self.w["n_text_head"]
        h = self.layer_norm(g + ".attn_ln", x)
        x = x + torch.tanh(self.P[g + ".attn_gate"]) * self.attention(g + ".attn", h, video, H,
                                                                      vmask)
        return x + torch.tanh(self.P[g + ".ff_gate"]) * self.mlp(g + ".ff",
                                                                 self.layer_norm(g + ".ff_ln", x))

    def decoder_layer(self, i, x, audio, video, vmask, causal):
        H = self.w["n_text_head"]
        x = self.gated(i, x, video, vmask)
        n = f"decoder.blocks.{i}"
        h = self.layer_norm(n + ".attn_ln", x)
        x = x + self.attention(n + ".attn", h, h, H, causal)
        x = x + self.attention(n + ".cross_attn", self.layer_norm(n + ".cross_attn_ln", x),
                               audio, H)
        return x + self.mlp(n + ".mlp", self.layer_norm(n + ".mlp_ln", x))

    def forward(self, inp: dict, tokens: torch.Tensor) -> dict:
        """``inp`` from ``preprocess.model_inputs``; ``tokens [2B, n]`` the
        decoder's input ids, speaker 1's rows first -> logits ``[2B, n, V]``."""
        P = self.P
        B = inp["lip1"].shape[0]
        lengths = torch.cat([inp["lip1_len"], inp["lip2_len"]])
        with torch.no_grad():
            audio = self.audio(log_mel(inp["audio"], self.cfg))
            video = self.video(torch.cat([inp["lip1"], inp["lip2"]]), lengths)
        audio = torch.cat([audio, audio])
        video = self.dense("video_proj", video)
        T = video.shape[1]
        vmask = (torch.arange(T, device=video.device)[None] < lengths[:, None])[:, None, None, :]
        n = tokens.shape[1]
        causal = torch.ones(n, n, dtype=torch.bool, device=tokens.device).tril()
        x = P["decoder.token_embedding"][tokens] + P["decoder.positional_embedding"][:n]
        for i in range(self.w["n_text_layer"]):
            if self.checkpoint and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(self.decoder_layer, i, x, audio, video,
                                                      vmask, causal, use_reentrant=False)
            else:
                x = self.decoder_layer(i, x, audio, video, vmask, causal)
        x = self.layer_norm("decoder.ln", x)
        return {"logits": F.linear(self.q(x), self.q(P["decoder.token_embedding"])), "B": B}


IGNORE = -100


def labels(text: torch.Tensor, lengths: torch.Tensor, w: dict):
    """Labels ``[B, L]`` of ``lengths`` -> decoder ids ``[prompt, text...]`` and
    targets (``IGNORE`` where a position predicts no text id nor eot), each
    ``[B, len(prompt) + L]``."""
    prompt, eot = list(w["prompt"]), w["eot"]
    B, L = text.shape
    p = len(prompt)
    tokens = torch.full((B, p + L), eot, dtype=torch.long, device=text.device)
    targets = torch.full((B, p + L), IGNORE, dtype=torch.long, device=text.device)
    for b in range(B):
        k = int(lengths[b])
        row = text[b, :k].long()
        tokens[b, :p] = torch.tensor(prompt, device=text.device)
        tokens[b, p:p + k] = row
        targets[b, p - 1:p - 1 + k] = row
        targets[b, p - 1 + k] = eot
    return tokens, targets


def ce_loss(logits: torch.Tensor, targets: torch.Tensor, B: int) -> torch.Tensor:
    """The mean over both speakers of each one's row-mean of per-row token-mean
    cross-entropies."""
    total = 0.0
    for rows in (slice(0, B), slice(B, 2 * B)):
        lg, tg = logits[rows], targets[rows]
        per = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), tg.reshape(-1), ignore_index=IGNORE,
                              reduction="none").view(tg.shape)
        total = total + (per.sum(1) / (tg != IGNORE).sum(1)).mean() / 2
    return total
