"""The legacy-v0 training path: the ``sample_*`` directory reader and the
twin-CTC trainer of ``MultimodalCTCKoreanModel``.

Mirrors ``multimodal_av_model_tpu/train/legacy.py:34-145``:

* ``load_legacy_sample`` (``:34-77``): one ``sample_*`` directory
  (``frames_A/``, ``frames_B/``, ``mixed.wav``, ``gt_A.txt``, ``gt_B.txt``)
  -> numpy arrays.  The mixture's log-mel goes through K1
  (``ops/logmel.py:log_mel_spectrogram_cuda``, one launch per sample) on
  ``device``, the card unless the caller passes ``device="cpu"``, which
  takes its plain version.  Frames keep their channels, are resized on the
  host (``data/pipeline.py:_resize_bilinear_np``) and divided by 255, as in
  JAX, so K2 (which makes grey frames) does not run here.  Frames other than
  ``.npy`` need ``cv2``;
* ``scan_legacy_root`` (``:80-85``);
* ``LegacyTrainer`` (``:88-145``): f32, ``optax.adam(1e-4)`` (``GroupAdam``
  with one group: constant rate, no clipping), loss ``CTC_A + CTC_B``
  (blank 0, each the batch mean over label lengths) on the ``log_softmax``
  of each logit stream.  The model runs without the mel lengths, as JAX's
  ``loss_fn`` calls it; CTC reads them.  flax infers the input sizes at
  ``init``, the port takes them at construction (``image_size``,
  ``channels``, ``n_mels``).  ``fit`` prints ``[Epoch N] Loss: ...`` with
  the epoch's sum of losses and iterates ``batches`` anew every epoch, so a
  one-shot generator trains only in epoch 1, as in JAX.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable

import numpy as np
import torch

from ..config import AudioFrontendConfig, TrainConfig
from ..data.audio_io import load_audio
from ..data.pipeline import _resize_bilinear_np
from ..models.legacy import MultimodalCTCKoreanModel, init_legacy_weights
from ..ops.ctc import ctc_loss
from ..ops.logmel import log_mel_spectrogram_cuda
from ..text.korean import KoreanSyllableVocab
from .trainer import GroupAdam, TrainState, one_group_adam, place_batch


def load_legacy_sample(sample_dir: str, vocab: KoreanSyllableVocab,
                       frontend: AudioFrontendConfig | None = None, image_size: int = 96,
                       device: str = "cuda") -> dict:
    """One ``sample_*`` directory -> ``frames_A``/``frames_B`` ``[T, h, w, C]``
    f32 in 0..1, ``mel [frames, n_mels]`` and int32 ``label_A``/``label_B``."""
    frontend = frontend or AudioFrontendConfig()

    def load_frames(folder):
        frames = []
        for n in sorted(os.listdir(folder)):
            if n.endswith(".npy"):
                arr = np.load(os.path.join(folder, n))
            else:
                try:
                    import cv2
                except ImportError:
                    raise RuntimeError("non-npy frames need cv2")
                arr = cv2.imread(os.path.join(folder, n))[:, :, ::-1]
            frames.append(np.asarray(arr, np.float32))
        chw = np.moveaxis(np.stack(frames), -1, 1)                     # [T, C, H, W]
        resized = _resize_bilinear_np(chw, image_size, image_size)
        return np.moveaxis(resized, 1, -1) / 255.0                     # [T, h, w, C]

    audio = load_audio(os.path.join(sample_dir, "mixed.wav"), frontend.sample_rate)
    wave = torch.from_numpy(np.ascontiguousarray(audio, np.float32))[None].to(device)
    mel = log_mel_spectrogram_cuda(wave, frontend.sample_rate, frontend.n_fft,
                                   frontend.hop_length, frontend.win_length, frontend.n_mels)
    labels = {}
    for side in ("A", "B"):
        with open(os.path.join(sample_dir, f"gt_{side}.txt"), encoding="utf-8") as f:
            labels[side] = np.asarray(vocab.text_to_indices(f.read().strip()), np.int32)
    return {
        "frames_A": load_frames(os.path.join(sample_dir, "frames_A")),
        "frames_B": load_frames(os.path.join(sample_dir, "frames_B")),
        "mel": mel[0].cpu().numpy(),
        "label_A": labels["A"],
        "label_B": labels["B"],
    }


def scan_legacy_root(root_dir: str) -> list[str]:
    return sorted(os.path.join(root_dir, d) for d in os.listdir(root_dir)
                  if d.startswith("sample_"))


@dataclasses.dataclass
class LegacyTrainer:
    """Twin-CTC training of the legacy model on ``device``.  A batch holds
    ``frames_A``, ``frames_B`` ``[B, T, H, W, C]``, ``mel [B, T_mel,
    n_mels]``, ``mel_lengths``, ``label_A``, ``len_A``, ``label_B``,
    ``len_B`` (numpy arrays or tensors)."""

    vocab_size: int
    hidden_dim: int = 256
    learning_rate: float = 1e-4           # reference 이전 버전/train_ctc_korea.py:88
    blank_id: int = 0                     # KoreanSyllableVocab's blank
    dtype: torch.dtype = torch.float32
    image_size: tuple[int, int] = (96, 96)
    channels: int = 3
    n_mels: int = 80
    device: str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.model = MultimodalCTCKoreanModel(self.vocab_size, self.hidden_dim, self.image_size,
                                              self.channels, self.n_mels,
                                              self.dtype).to(self.device)

    def make_optimizer(self) -> GroupAdam:
        """``optax.adam(learning_rate)``: one group, constant rate, no clipping."""
        return one_group_adam(self.model, TrainConfig(learning_rate=self.learning_rate))

    def init_state(self, seed: int = 0) -> TrainState:
        """Parameters from ``init_legacy_weights`` with a generator seeded by
        ``seed``, and a fresh optimizer (the model has no dropout)."""
        init_legacy_weights(self.model, torch.Generator().manual_seed(seed))
        return TrainState(0, self.model, self.make_optimizer(),
                          torch.Generator(device=self.device).manual_seed(seed))

    def loss_fn(self, model, batch: dict) -> torch.Tensor:
        """``CTC_A + CTC_B`` of a placed batch (``legacy.py:110-121``)."""
        logits_a, logits_b = model(batch["frames_A"], batch["frames_B"], batch["mel"])
        log_a = torch.log_softmax(logits_a.float(), dim=-1)
        log_b = torch.log_softmax(logits_b.float(), dim=-1)
        loss_a = ctc_loss(log_a, batch["label_A"], batch["mel_lengths"], batch["len_A"],
                          self.blank_id)
        loss_b = ctc_loss(log_b, batch["label_B"], batch["mel_lengths"], batch["len_B"],
                          self.blank_id)
        return loss_a + loss_b

    def train_step(self, state: TrainState, batch: dict):
        """Forward, backward and an Adam update -> ``(state, loss)``, the loss
        a device scalar."""
        state.model.zero_grad(set_to_none=True)
        loss = self.loss_fn(state.model, place_batch(batch, self.device))
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    def fit(self, state: TrainState, batches: Iterable[dict], epochs: int = 10,
            log_fn: Callable[[str], None] = print) -> TrainState:
        """``epochs`` passes over ``batches`` (iterated anew each epoch), one
        ``[Epoch N] Loss: <sum of the epoch's losses>`` line each."""
        for epoch in range(1, epochs + 1):
            total = 0.0
            for batch in batches:
                state, loss = self.train_step(state, batch)
                total += float(loss)
            log_fn(f"[Epoch {epoch}] Loss: {total:.4f}")
        return state
