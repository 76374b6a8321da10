"""On-device batch preprocessing: raw media -> model-ready tensors.

Mirrors ``multimodal_av_model_tpu/data/device_pipeline.py:29-100``.  Host work
is decode and pad-to-bucket; on the device run the two-speaker mixing with its
0/1/2/3 masks (``mixing.mix_pair_batched_device``) and the lip preprocessing
(grey, bilinear resize, /255), which is kernel K2 on a CUDA device.  The output
has the collator's layout, so the model does not know which pipeline made it.
A model with an attention decoder gives ``device_preprocessed_batches`` a
``window`` that the mixture and its masks are padded or cut to, and the
``decoder_rows`` that its batch gains (Whisper-Flamingo:
``models/whisper_flamingo.pipeline_options``, Whisper's 30 s window and
``whisper_labels``).
Spans (``tracing``): ``preprocess`` over a call, ``preprocess.h2d`` over each
copy of a raw input, ``preprocess.mix`` and ``preprocess.lips`` (K2); the
decoder's target tokens of the valid rows are counted as ``decoder_tokens``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.resize import lip_preprocess_cuda
from ..tracing import count, span
from .mixing import MASK_PAD, mix_pair_batched_device

IGNORE = -100       # a target position that is no target (F.cross_entropy's ignore_index)


def _on(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    with span("preprocess.h2d"):
        return x.to(device)


def whisper_labels(text, lengths, prompt, eot: int):
    """Whisper's teacher-forced decoder rows from labels ``text [B, L]`` of
    ``lengths [B]`` (numpy): input ids ``[prompt, text..., eot...]`` and
    targets ``[IGNORE..., text..., eot, IGNORE...]``, both ``[B, len(prompt)
    + L]`` int64.  The last prompt position predicts the first text id, the
    last text position ``eot``; the prompt is no target."""
    text = np.asarray(text, np.int64)
    lengths = np.asarray(lengths, np.int64)
    B, L = text.shape
    P = len(prompt)
    tokens = np.full((B, P + L), eot, np.int64)
    tokens[:, :P] = prompt
    pos = np.arange(L)[None]
    tokens[:, P:] = np.where(pos < lengths[:, None], text, eot)
    j = np.arange(P + L)[None] - (P - 1)            # the text index a position predicts
    picked = np.take_along_axis(text, np.clip(j, 0, L - 1).repeat(B, 0), axis=1)
    targets = np.where((j >= 0) & (j < lengths[:, None]), picked,
                       np.where(j == lengths[:, None], eot, IGNORE))
    return tokens, targets


def preprocess_batch_device(lips1_raw, lips2_raw, audio1, audio2, audio1_len,
                            audio2_len, out_size: int = 96, device="cuda", window=None,
                            decoder_rows=None, valid=None):
    """Args:
      lips1_raw, lips2_raw: ``[B, T, H, W, C]`` raw frames (uint8 or float
        0..255), zero-padded past each clip's length.
      audio1, audio2: ``[B, S]`` per-speaker waveforms, zero-padded.
      audio1_len, audio2_len: ``[B]`` true sample counts.
      device: where the work runs; the CPU only when asked for.
      window: None, or the samples the mixture and its masks are padded
        (pad code 3) or cut to.
      decoder_rows: None, or host arrays (``whisper_labels``' ``tokens{1,2}``
        and ``targets{1,2}``) copied to ``device`` with the rest; the targets
        of the rows that ``valid`` (``[B]``, None: all) keeps are counted.

    Inputs may be numpy arrays or tensors; they are moved to ``device``.
    Returns a dict with ``lip1/lip2 [B,T,1,out,out]`` f32, ``audio [B,S]``,
    ``mask1/mask2 [B,S]`` int32 (pad = 3) and ``audio_lengths [B]``.
    """
    device = torch.device(device)

    def prep_lips(raw):
        raw = _on(raw, device)
        B, T, H, W, C = raw.shape
        with span("preprocess.lips"):
            out = lip_preprocess_cuda(raw.reshape(B * T, H, W, C), out_size)
        return out.reshape(B, T, 1, out_size, out_size)

    with span("preprocess"):
        waves = [_on(x, device) for x in (audio1, audio2, audio1_len, audio2_len)]
        with span("preprocess.mix"):
            mixed, mask1, mask2, mix_len = mix_pair_batched_device(*waves)
            if window is not None:
                S = mixed.shape[1]
                if S >= window:
                    mixed, mask1, mask2 = mixed[:, :window], mask1[:, :window], mask2[:, :window]
                else:
                    mixed = F.pad(mixed, (0, window - S))
                    mask1, mask2 = (F.pad(m, (0, window - S), value=MASK_PAD)
                                    for m in (mask1, mask2))
        out = {
            "lip1": prep_lips(lips1_raw),
            "lip2": prep_lips(lips2_raw),
            "audio": mixed,
            "mask1": mask1,
            "mask2": mask2,
            "audio_lengths": mix_len,
        }
        for k, v in (decoder_rows or {}).items():
            out[k] = _on(v, device)
            if k.startswith("targets"):
                hit = v != IGNORE
                if valid is not None:
                    hit &= np.asarray(valid)[:, None] > 0
                count("decoder_tokens", int(hit.sum()))
        return out


_PASSTHROUGH_KEYS = (
    "lip1_lengths", "lip2_lengths",
    "text1", "text1_lengths", "text2", "text2_lengths",
    "valid", "num_real",
)


def device_preprocessed_batches(raw_batches, out_size: int = 96, device="cuda", window=None,
                                decoder_rows=None):
    """Wrap raw collated batches (``collate.collate_pairs_raw``) into the
    model's batch layout, preprocessing on ``device``.  ``window``: None, or
    the samples the mixture and its masks are padded or cut to;
    ``decoder_rows``: None, or a function of a raw batch -> host arrays
    (``tokens{1,2}``, ``targets{1,2}``) the batch gains."""
    for rb in raw_batches:
        proc = preprocess_batch_device(
            rb["lip1_raw"], rb["lip2_raw"], rb["audio1"], rb["audio2"],
            rb["audio1_len"], rb["audio2_len"], out_size=out_size, device=device,
            window=window, decoder_rows=decoder_rows(rb) if decoder_rows else None,
            valid=rb.get("valid"))
        batch = {k: rb[k] for k in _PASSTHROUGH_KEYS if k in rb}
        batch.update(proc)
        yield batch
