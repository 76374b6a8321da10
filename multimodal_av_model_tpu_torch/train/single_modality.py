"""Training of the audio-only and visual-only families.

Mirrors ``multimodal_av_model_tpu/train/single_modality.py:25-349``: one CTC
trainer over the single-stream batch schema ``{inputs, meta, labels,
label_lengths}`` (plus ``valid`` and ``num_real`` on real data), for
``AudioOnlyCTC`` (``meta``: the boolean sample mask, K1 in the forward) and
``VisualOnlyCTC`` (``meta``: the frame counts).  JAX wraps each model in an
adapter; here both models take ``(inputs, meta, train=, generator=)``
directly.

* The families compute in f32 unless asked otherwise: the JAX CLI builds
  their trainers without a dtype, so ``model.dtype`` does not reach them.
* The optimizer is ``chain(clip_by_global_norm, adam(schedule))`` at
  ``train.learning_rate``: ``GroupAdam`` with one group, whose norm is the
  global norm and whose schedule reads the count before incrementing it.
  ``train.grad_accum_steps`` is not read, as in JAX.
* The loss is mean CTC (each sample over its label length), or with
  ``valid`` the ``valid``-weighted mean, so a flush batch's loss is its
  unpadded batch's.  BatchNorm statistics update in train mode.
* ``evaluate`` decodes by ``decode.algorithm`` (``infer.decode_ids``, LM
  fusion included) or greedily.
* ``fit`` raises on a non-finite loss, keeps the rolling checkpoints of
  ``{"state", "epoch"}`` and on SIGTERM or SIGINT saves ``last.ckpt`` as the
  previous epoch and returns (``single_modality.py:157-206``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..config import Config
from ..infer import decode_ids, load_fusion_lm
from ..models.av_model import AudioOnlyCTC, VisualOnlyCTC
from ..ops.ctc import ctc_loss
from ..ops.metrics import cer_counts, rate_from_counts, wer_counts
from .checkpoints import CheckpointManager
from .preempt import GracefulShutdown
from .profiling import NonFiniteLossError, check_finite
from .trainer import GroupAdam, TrainState, one_group_adam, place_batch, seeded_state


@dataclasses.dataclass
class SingleModalityTrainer:
    """CTC training of a model ``(inputs, meta, train=, generator=) ->
    (log_probs, input_lengths)`` on ``device``."""

    config: Config
    model: Any
    tokenizer: Any
    device: str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.model = self.model.to(self.device)
        self.lm = load_fusion_lm(self.config.decode.lm_path, self.device)

    def make_optimizer(self) -> GroupAdam:
        return one_group_adam(self.model, self.config.train)

    def init_state(self, seed: int = 0) -> TrainState:
        """``seeded_state`` of the model with a fresh one-group optimizer."""
        return seeded_state(self.model, self.make_optimizer, self.device, seed)

    def _place(self, batch: dict) -> dict:
        return place_batch(batch, self.device)

    def _loss(self, model, batch: dict, train: bool, generator=None):
        """``single_modality.py:56-86`` on a placed batch -> ``(loss,
        log_probs, input_lengths)``."""
        lp, il = model(batch["inputs"], batch["meta"], train=train, generator=generator)
        blank = self.config.model.decoder.blank_id
        valid = batch.get("valid")
        if valid is None:
            return ctc_loss(lp, batch["labels"], il, batch["label_lengths"], blank), lp, il
        per = ctc_loss(lp, batch["labels"], il, batch["label_lengths"], blank, reduction="none")
        per = per / batch["label_lengths"].clamp(min=1).float()
        return (per * valid).sum() / valid.sum().clamp(min=1.0), lp, il

    def train_step(self, state: TrainState, batch: dict):
        """Forward, backward and an optimizer update -> ``(state, loss)``, the
        loss a device scalar."""
        model = state.model
        model.zero_grad(set_to_none=True)
        loss, _, _ = self._loss(model, self._place(batch), True, state.generator)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    @torch.no_grad()
    def eval_forward(self, state: TrainState, inputs, meta):
        """Eval-mode ``(log_probs, input_lengths)``."""
        placed = self._place({"inputs": inputs, "meta": meta})
        return state.model(placed["inputs"], placed["meta"], train=False)

    @torch.no_grad()
    def evaluate(self, batches: Iterable[dict], state: TrainState, use_beam: bool = True):
        """``single_modality.py:121-155`` -> ``(mean loss, wer, cer)`` over
        the real rows of every batch."""
        refs, hyps = [], []
        total, n = 0.0, 0
        for batch in batches:
            num_real = int(batch.get("num_real", batch["inputs"].shape[0]))
            placed = self._place(batch)
            loss, lp, il = self._loss(state.model, placed, False)
            total += float(loss)
            n += 1
            ids, lens = decode_ids(self.config, lp, il, use_beam, self.lm)
            ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
            labels = placed["labels"].cpu().numpy()
            llen = placed["label_lengths"].cpu().numpy()
            for b in range(num_real):
                hyps.append(self.tokenizer.decode(ids[b, : lens[b]].tolist()))
                refs.append(self.tokenizer.decode(labels[b, : llen[b]].tolist()))
        return (total / max(n, 1), rate_from_counts(*wer_counts(refs, hyps)),
                rate_from_counts(*cer_counts(refs, hyps)))

    def fit(self, state: TrainState, train_factory: Callable[[], Iterable[dict]],
            val_factory: Callable[[], Iterable[dict]], log_fn: Callable[[str], None] = print,
            start_epoch: int = 1) -> TrainState:
        """Epochs ``start_epoch .. max_epochs`` of ``train_step`` over
        ``train_factory()`` then ``evaluate`` over ``val_factory()``, one
        ``[epoch N]`` line each (JAX's, with the epoch's utt/s and seconds
        added) and the rolling checkpoints (``single_modality.py:157-206``).
        With ``async_dispatch`` the losses fold into a device sum with an
        all-finite flag, read once per epoch."""
        tcfg = self.config.train
        ckpts = (CheckpointManager(tcfg.checkpoint_dir, async_io=tcfg.async_checkpoint,
                                   layout=tcfg.checkpoint_layout)
                 if tcfg.checkpoint_dir else None)
        with GracefulShutdown(enable=tcfg.handle_signals) as stop:
            for epoch in range(start_epoch, tcfg.max_epochs + 1):
                total, n, utts = 0.0, 0, 0
                acc = ok = None
                t0 = time.perf_counter()
                for batch in train_factory():
                    if stop.requested:
                        break
                    state, loss = self.train_step(state, batch)
                    if tcfg.async_dispatch:
                        acc = loss.float() if acc is None else acc + loss.float()
                        good = torch.isfinite(loss)
                        ok = good if ok is None else ok & good
                    else:
                        loss = float(loss)
                        if tcfg.check_finite:
                            check_finite({"loss": loss}, step=n)
                        total += loss
                    n += 1
                    utts += int(batch.get("num_real", batch["inputs"].shape[0]))
                if acc is not None:
                    if tcfg.check_finite and not bool(ok):
                        raise NonFiniteLossError(f"non-finite loss within epoch {epoch}")
                    total = float(acc)
                train_s = time.perf_counter() - t0
                if stop.requested:
                    if ckpts is not None:
                        ckpts.save_now({"state": state, "epoch": epoch - 1})
                        log_fn(f"preempted: saved {ckpts.last} mid-epoch {epoch} "
                               f"(resume will redo the epoch)")
                    break
                eval_loss, eval_wer, eval_cer = self.evaluate(val_factory(), state)
                log_fn(f"[epoch {epoch}] train_loss={total / max(n, 1):.4f} "
                       f"eval_loss={eval_loss:.4f} wer={eval_wer:.3f} cer={eval_cer:.3f} "
                       f"utt/s={utts / max(train_s, 1e-9):.2f} train_s={train_s:.3f}")
                if ckpts is not None:
                    ckpts.on_epoch_end({"state": state, "epoch": epoch}, eval_loss, eval_wer)
        if ckpts is not None:
            ckpts.wait()
        return state


def make_audio_trainer(cfg: Config, tokenizer, dtype: torch.dtype | None = None,
                       device: str = "cuda") -> SingleModalityTrainer:
    """``AudioOnlyCTC`` (f32 unless ``dtype``) in a ``SingleModalityTrainer``."""
    return SingleModalityTrainer(cfg, AudioOnlyCTC(cfg.model, dtype or torch.float32),
                                 tokenizer, device)


def make_visual_trainer(cfg: Config, tokenizer, dtype: torch.dtype | None = None,
                        device: str = "cuda") -> SingleModalityTrainer:
    """``VisualOnlyCTC`` (f32 unless ``dtype``) in a ``SingleModalityTrainer``."""
    return SingleModalityTrainer(cfg, VisualOnlyCTC(cfg.model, dtype or torch.float32),
                                 tokenizer, device)


def utterance_batches(entries, tokenizer, family: str, batch_size: int,
                      sample_rate: int = 16000, max_samples: int = 160000,
                      max_frames: int = 448, lip_size: int = 96, max_label_len: int = 128,
                      drop_last: bool = False):
    """Single-utterance batches from manifest entries (``single_modality.py:254-322``):
    ``family`` "audio" (the sentence's slice of its WAV -> ``[B, max_samples]``
    waveform + sample mask) or "visual" (its lip crops, preprocessed on the
    host -> ``[B, max_frames, 1, lip_size, lip_size]`` + frame counts).  Every
    batch has the full static shape: a last partial batch repeats its last
    row with ``valid`` 0, and ``num_real`` counts the real rows (unless
    ``drop_last``).  Labels are read from ``text_path``, as JAX does: its
    entries are dicts, so its ``getattr(entry, "sentence_text", "")`` is
    always empty."""
    from ..data.audio_io import WavCache
    from ..data.pipeline import preprocess_lip_clip_host

    wavs = WavCache(target_sr=sample_rate)
    buf = []

    def flush():
        num_real = len(buf)
        rows = buf + [buf[-1]] * (batch_size - num_real)
        B = batch_size
        labels = np.zeros((B, max_label_len), np.int32)
        llen = np.zeros((B,), np.int32)
        for i, (_, lab) in enumerate(rows):
            lab = lab[:max_label_len]
            labels[i, : len(lab)] = lab
            llen[i] = len(lab)
        if family == "audio":
            inputs = np.zeros((B, max_samples), np.float32)
            meta = np.zeros((B, max_samples), bool)
            for i, (x, _) in enumerate(rows):
                n = min(len(x), max_samples)
                inputs[i, :n] = x[:n]
                meta[i, :n] = True
        else:
            inputs = np.zeros((B, max_frames, 1, lip_size, lip_size), np.float32)
            meta = np.zeros((B,), np.int32)
            for i, (x, _) in enumerate(rows):
                n = min(x.shape[0], max_frames)
                inputs[i, :n] = x[:n]
                meta[i] = n
        valid = np.zeros((B,), np.float32)
        valid[:num_real] = 1.0
        return {"inputs": inputs, "meta": meta, "labels": labels, "label_lengths": llen,
                "valid": valid, "num_real": np.int32(num_real)}

    for entry in entries:
        with open(entry["text_path"], encoding="utf-8") as f:
            label = np.asarray(tokenizer.encode(f.read().strip()), np.int64)
        if family == "audio":
            x = wavs.load_segment(entry["audio_path"], entry["start_time"], entry["end_time"])
        else:
            x = preprocess_lip_clip_host(np.load(entry["lip_path"]), lip_size)
        buf.append((x, label))
        if len(buf) == batch_size:
            yield flush()
            buf = []
    if buf and not drop_last:
        yield flush()


def synthetic_audio_batches(tokenizer, batch_size: int, n_batches: int, samples: int = 16000,
                            label_len: int = 8, seed: int = 0):
    """Seeded noise waveforms and random labels (``single_modality.py:325-335``)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield {
            "inputs": (rng.standard_normal((batch_size, samples)) * 0.1).astype(np.float32),
            "meta": np.ones((batch_size, samples), bool),
            "labels": rng.integers(5, tokenizer.vocab_size,
                                   size=(batch_size, label_len)).astype(np.int32),
            "label_lengths": np.full((batch_size,), label_len, np.int32),
        }


def synthetic_visual_batches(tokenizer, batch_size: int, n_batches: int, frames: int = 16,
                             size: int = 96, label_len: int = 4, seed: int = 0):
    """Seeded uniform lip frames and random labels (``single_modality.py:338-349``)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield {
            "inputs": rng.uniform(size=(batch_size, frames, 1, size, size)).astype(np.float32),
            "meta": np.full((batch_size,), frames, np.int32),
            "labels": rng.integers(5, tokenizer.vocab_size,
                                   size=(batch_size, label_len)).astype(np.int32),
            "label_lengths": np.full((batch_size,), label_len, np.int32),
        }
