"""Self-supervised pretraining of the audio encoder: the SSL family.

Mirrors ``multimodal_av_model_tpu/train/ssl_pretrain.py:33-143``: the audio
encoder with its span masking (``mask_spans``) and an f32 prediction head,
trained by masked-span InfoNCE (``ops/ssl.py``) on the mixture waveforms
alone.  Its ``audio_encoder`` subtree, without the SSL-only
``mask_embedding``, grafts into the flagship (``train.audio_init_ckpt``).

* The model is built in f32 unless asked otherwise, as JAX's trainer is:
  ``model.dtype`` does not reach it.
* The optimizer is plain Adam at ``train.learning_rate``: no clipping, no
  schedule, no accumulation (``GroupAdam`` with one group and a constant
  rate).
* The state is a ``TrainState``: the dropout generator is part of it, so it
  checkpoints and a resumed run draws what the uninterrupted one would.
* ``fit`` takes the span generator: seeded per epoch, a resumed run replays
  the masks it would have drawn.  The spans are drawn on the host per batch
  and copied to the device; the sample mask is speaker 1's non-pad mask
  (``mask1 != 3``), as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from ..config import Config, ModelConfig, require_flagship
from ..data.mixing import MASK_PAD
from ..models.audio import AudioEncoder
from ..models.layers import Dense
from ..ops.ssl import make_span_mask, masked_infonce_loss
from .trainer import GroupAdam, TrainState, one_group_adam, place_batch, seeded_state


class MaskedAudioPretrainModel(nn.Module):
    """``AudioEncoder`` (with ``mask_embedding``) + ``ssl_head``, a Dense
    ``output_dim -> d_model`` in f32 (``ssl_pretrain.py:33-51``)."""

    def __init__(self, config: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        require_flagship(config, "the SSL pretraining family")
        self.config, self.dtype = config, dtype
        self.audio_encoder = AudioEncoder(config.audio, config.frontend, dtype,
                                          mask_embedding=True)
        self.ssl_head = Dense(config.audio.output_dim, config.audio.d_model,
                              dtype=torch.float32)

    def forward(self, audio, sample_mask, mask_spans, generator=None):
        """``audio [B, S]``, ``sample_mask [B, S]`` bool, ``mask_spans [B,
        T_enc]`` bool -> ``(predictions, targets, frame_valid)``; train mode
        when a dropout ``generator`` is given."""
        last, _, frame_valid, targets = self.audio_encoder(audio, sample_mask, generator,
                                                           mask_spans)
        return self.ssl_head(last.to(torch.float32)), targets, frame_valid


def flagship_audio_params(ssl_state_dict: dict) -> dict:
    """The ``audio_encoder.*`` entries of an SSL model's state dict without
    ``mask_embedding``: what grafts into the flagship
    (``ssl_pretrain.py:54-60``)."""
    return {k: v for k, v in ssl_state_dict.items()
            if k.startswith("audio_encoder.") and k != "audio_encoder.mask_embedding"}


@dataclasses.dataclass
class MaskedAudioPretrainer:
    """The SSL training loop (``ssl_pretrain.py:63-143``) on ``device``."""

    config: Config
    mask_prob: float = 0.065
    span: int = 10
    temperature: float = 0.1
    dtype: torch.dtype = torch.float32
    device: str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.model = MaskedAudioPretrainModel(self.config.model, self.dtype).to(self.device)

    def enc_frames(self, n_samples: int) -> int:
        return AudioEncoder.output_length(self.config.model.audio, self.config.model.frontend,
                                          n_samples)

    def make_optimizer(self) -> GroupAdam:
        """Plain Adam at ``learning_rate`` (``optax.adam``)."""
        return one_group_adam(self.model, dataclasses.replace(
            self.config.train, lr_schedule="constant", grad_clip_norm=None))

    def init_state(self, seed: int = 0) -> TrainState:
        """``seeded_state`` of the model with a fresh optimizer."""
        return seeded_state(self.model, self.make_optimizer, self.device, seed)

    def train_step(self, state: TrainState, audio, sample_mask, spans):
        """One Adam step on the InfoNCE of one batch (arrays or tensors) ->
        ``(state, loss)``, the loss a device scalar."""
        model = state.model
        model.zero_grad(set_to_none=True)
        b = place_batch({"audio": audio, "sample_mask": sample_mask, "spans": spans},
                        self.device)
        spans = b["spans"]
        preds, targets, frame_valid = model(b["audio"], b["sample_mask"], spans,
                                            generator=state.generator)
        loss = masked_infonce_loss(preds, targets, spans, frame_valid, self.temperature)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    def fit(self, state: TrainState, batches: Iterable[dict], log_every: int = 100,
            log_fn: Callable[[str], None] = print, span_rng: np.random.Generator | None = None,
            stop=None):
        """One pass over ``batches`` -> ``(state, last loss or None)``.  The
        spans come from ``span_rng`` (default ``default_rng(0)``); ``stop``
        (a ``GracefulShutdown``) is read before each step."""
        if span_rng is None:
            span_rng = np.random.default_rng(0)
        loss = None
        for i, batch in enumerate(batches):
            if stop is not None and stop.requested:
                break
            audio = batch["audio"]
            spans = make_span_mask(audio.shape[0], self.enc_frames(audio.shape[1]),
                                   self.mask_prob, self.span, span_rng)
            state, loss = self.train_step(state, audio, batch["mask1"] != MASK_PAD, spans)
            if i % log_every == 0:
                log_fn(f"[ssl {i}] infonce={float(loss):.4f}")
        return state, (float(loss) if loss is not None else None)
