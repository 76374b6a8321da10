"""The flagship two-speaker audio-visual CTC model, and the audio-only and
visual-only CTC models.

``MultiSpeakerAVModel`` mirrors ``multimodal_av_model_tpu/models/av_model.py:27-145``:
both speakers run as one ``[2B]`` batch through the visual encoder, fusion
and decoder (so train-mode BatchNorm takes its statistics over the joint
``2B`` batch).  With ``shared_audio_pass`` (the default) the mixture is
encoded once, on the union of the two speakers' non-pad masks, and reused
for both (exact in eval; in train mode both speakers share one dropout
draw).  Without it, the reference-shaped double pass: the encoder runs on
the mixture twice as one ``[2B]`` batch (K1 once, on ``[2B, S]``), each row
under its own speaker's mask, each with its own dropout draw.  The fusion has no
train-mode behaviour (its attention has no dropout, the BiLSTM none, and the
transformer temporal model is built with dropout 0, as in JAX).
``AudioOnlyCTC`` mirrors ``av_model.py:148-161`` and ``VisualOnlyCTC``
``av_model.py:164-178``, each in eval and train mode; their parameter names
are the flagship's (``audio_encoder``, ``visual_encoder``, ``decoder.head``),
so their encoders graft into it.  ``build_av_model`` builds the two-speaker
model that ``model.arch`` selects: this flagship, AV-HuBERT
(``models/avhubert.py``) or Whisper-Flamingo (``models/whisper_flamingo.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig, require_arch
from ..data.mixing import MASK_PAD
from ..tracing import span
from .audio import AudioEncoder
from .decoder import CTCDecoder
from .fusion import CrossAttentionFusion
from .layers import Dense
from .visual import VisualEncoder


def nchw_clip_to_channels_last(lips):
    """Collate layout ``[B, T, 1, H, W]`` -> ``[B, T, H, W, 1]``."""
    return lips.permute(0, 1, 3, 4, 2)


def downsample_mask_to(mask, T_enc: int):
    """Sample-rate speaker mask -> encoder frame rate, nearest, by integer
    index math (``av_model.py:33-38``)."""
    S = mask.shape[-1]
    idx = torch.clamp(torch.arange(T_enc, device=mask.device) * S // T_enc, 0, S - 1)
    return mask.index_select(-1, idx)


class MultiSpeakerAVModel(nn.Module):
    """Two-speaker audio-visual CTC model with contrastive feature taps."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        require_arch(config, "MultiSpeakerAVModel")
        self.config, self.dtype = config, dtype
        fused_out = 2 * config.fusion.fused_dim
        self.visual_encoder = VisualEncoder(config.visual, dtype)
        self.audio_encoder = AudioEncoder(config.audio, config.frontend, dtype)
        self.fusion = CrossAttentionFusion(config.fusion, config.visual.output_dim,
                                           config.audio.output_dim, dtype)
        self.decoder = CTCDecoder(config.decoder, fused_out, dtype)
        self.contrastive_proj = Dense(config.audio.d_model, config.contrastive.projection_dim,
                                      dtype=torch.float32)
        if not config.shared_audio_pass:
            # The encoder's rows are two stacked batches, one per speaker: a
            # mesh rank's dropout and SpecAugment draws keep its block of each.
            for m in self.audio_encoder.modules():
                if hasattr(m, "parts"):
                    m.parts = 2

    def forward(self, lip1, lip2, audio, mask1, mask2, lip1_len=None, lip2_len=None,
                train: bool = False, stop_visual_grad: bool = False, generator=None):
        """Collate layouts: lips ``[B, T, 1, H, W]``, audio ``[B, S]``, masks
        ``[B, S]``.  Returns ``log_probs{1,2} [B, T_v, V]``,
        ``input_lengths{1,2} [B]``, ``contrast{1,2} [B, T_enc, P]`` and
        ``mask_ds{1,2} [B, T_enc]``.

        ``train``: batch statistics in the BatchNorms (their running
        statistics update) and dropout in the audio encoder, drawn from
        ``generator`` (a ``torch.Generator`` on the inputs' device).
        ``stop_visual_grad``: the visual encoder runs without autograd (its
        parameters get no gradient; in train mode its running statistics
        still update, as flax's ``mutable=["batch_stats"]`` does).
        """
        if train and generator is None and self.config.audio.dropout > 0:
            raise ValueError("train mode with audio dropout needs a dropout generator")
        B, T_v = lip1.shape[0], lip1.shape[1]
        lips = torch.cat([nchw_clip_to_channels_last(lip1),
                          nchw_clip_to_channels_last(lip2)], 0)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_visual_grad), \
                span("encoders.visual"):
            v = self.visual_encoder(lips, train)

        masks = torch.cat([mask1, mask2], 0)
        lens = None
        if lip1_len is not None or lip2_len is not None:
            full = torch.full((B,), T_v, dtype=torch.int32, device=lip1.device)
            lens = torch.cat([full if lip1_len is None else lip1_len,
                              full if lip2_len is None else lip2_len], 0)

        gen = generator if train else None
        with span("encoders.audio"):
            if self.config.shared_audio_pass:
                # One audio pass on the union mask serves both speakers.
                last_1, middle_1, _ = self.audio_encoder(
                    audio, sample_mask=(mask1 != MASK_PAD) | (mask2 != MASK_PAD), generator=gen)
                last = torch.cat([last_1, last_1], 0)
                middle = torch.cat([middle_1, middle_1], 0)
            else:
                # The double pass (av_model.py:127-130): [2B] rows, each speaker's mask.
                last, middle, _ = self.audio_encoder(
                    torch.cat([audio, audio], 0), sample_mask=masks != MASK_PAD, generator=gen)
        mask_ds = downsample_mask_to(masks, last.shape[1])
        contrast = self.contrastive_proj(middle.to(torch.float32))
        with span("fusion"):
            fused, input_lengths = self.fusion(v, last, mask_ds, visual_lengths=lens)
        with span("decoder"):
            log_probs = self.decoder(fused)
        return {
            "log_probs1": log_probs[:B], "input_lengths1": input_lengths[:B],
            "contrast1": contrast[:B], "mask_ds1": mask_ds[:B],
            "log_probs2": log_probs[B:], "input_lengths2": input_lengths[B:],
            "contrast2": contrast[B:], "mask_ds2": mask_ds[B:],
        }


def build_av_model(config: ModelConfig, dtype: torch.dtype = torch.float32) -> nn.Module:
    """The two-speaker model that ``config.arch`` selects: "flagship"
    (``MultiSpeakerAVModel``), "avhubert" (``avhubert.AVHubertCTC``) or
    "whisper_flamingo" (``whisper_flamingo.WhisperFlamingo``).  All take the
    collate layout; the two CTC models return ``log_probs{1,2}`` and
    ``input_lengths{1,2}`` (only the flagship has the contrastive taps),
    Whisper-Flamingo takes each speaker's decoder ids and returns
    ``logits{1,2}``."""
    if config.arch == "flagship":
        return MultiSpeakerAVModel(config, dtype)
    if config.arch == "avhubert":
        from .avhubert import AVHubertCTC

        return AVHubertCTC(config, dtype)
    if config.arch == "whisper_flamingo":
        from .whisper_flamingo import WhisperFlamingo

        return WhisperFlamingo(config, dtype)
    raise ValueError(f"unknown model.arch {config.arch!r}; known: flagship, avhubert, "
                     "whisper_flamingo")


class AudioOnlyCTC(nn.Module):
    """Log-mel (K1) -> Conformer -> CTC head (``av_model.py:148-161``): the
    audio-only model of the audio family, the streaming and the audio
    serving paths.  Parameter names follow the flax module's
    (``audio_encoder``, ``decoder.head``)."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        require_arch(config, "the audio-only model")
        self.config, self.dtype = config, dtype
        self.audio_encoder = AudioEncoder(config.audio, config.frontend, dtype)
        self.decoder = CTCDecoder(config.decoder, config.audio.output_dim, dtype)

    def forward(self, audio, sample_mask=None, train: bool = False, generator=None):
        """``audio [B, S]`` f32, ``sample_mask [B, S]`` bool (True = valid;
        None: all valid) -> ``(log_probs [B, T_enc, V], input_lengths [B]
        int32)``.  ``train``: dropout and SpecAugment drawn from
        ``generator`` (a ``torch.Generator`` on the input's device)."""
        a = self.config.audio
        if train and generator is None and (
                a.dropout > 0 or a.specaug_freq_masks > 0 or a.specaug_time_masks > 0):
            raise ValueError("train mode with dropout or SpecAugment needs a generator")
        last, _, frame_valid = self.audio_encoder(audio, sample_mask,
                                                  generator if train else None)
        return self.decoder(last), frame_valid.sum(dim=1).to(torch.int32)


class VisualOnlyCTC(nn.Module):
    """Lip frames -> visual encoder -> CTC head (``av_model.py:164-178``), the
    model of the visual family.  ``visual_encoder.*`` is the flagship's
    subtree, so its checkpoint grafts through ``train.visual_init_ckpt``."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        require_arch(config, "the visual-only model")
        self.config, self.dtype = config, dtype
        self.visual_encoder = VisualEncoder(config.visual, dtype)
        self.decoder = CTCDecoder(config.decoder, config.visual.output_dim, dtype)

    def forward(self, lips, lip_lengths=None, train: bool = False, generator=None):
        """``lips [B, T, 1, H, W]`` f32, ``lip_lengths [B]`` (None: T) ->
        ``(log_probs [B, T, V], lengths [B] int32)``.  ``train``: batch
        statistics in the BatchNorms, whose running statistics update; the
        visual encoder has no dropout, so ``generator`` is not drawn from."""
        feat = self.visual_encoder(nchw_clip_to_channels_last(lips), train)
        log_probs = self.decoder(feat)
        if lip_lengths is None:
            lip_lengths = torch.full((lips.shape[0],), lips.shape[1], dtype=torch.int32,
                                     device=lips.device)
        return log_probs, lip_lengths.to(torch.int32)
