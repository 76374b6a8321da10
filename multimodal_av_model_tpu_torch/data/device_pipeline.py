"""On-device batch preprocessing: raw media -> model-ready tensors.

Mirrors ``multimodal_av_model_tpu/data/device_pipeline.py:29-100``.  Host work
is decode and pad-to-bucket; on the device run the two-speaker mixing with its
0/1/2/3 masks (``mixing.mix_pair_batched_device``) and the lip preprocessing
(grey, bilinear resize, /255), which is kernel K2 on a CUDA device.  The output
has the collator's layout, so the model does not know which pipeline made it.
Spans (``tracing``): ``preprocess`` over a call, ``preprocess.h2d`` over each
copy of a raw input, ``preprocess.mix`` and ``preprocess.lips`` (K2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import lip_preprocess_cuda
from ..tracing import span
from .mixing import mix_pair_batched_device


def _on(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    with span("preprocess.h2d"):
        return x.to(device)


def preprocess_batch_device(lips1_raw, lips2_raw, audio1, audio2, audio1_len,
                            audio2_len, out_size: int = 96, device="cuda"):
    """Args:
      lips1_raw, lips2_raw: ``[B, T, H, W, C]`` raw frames (uint8 or float
        0..255), zero-padded past each clip's length.
      audio1, audio2: ``[B, S]`` per-speaker waveforms, zero-padded.
      audio1_len, audio2_len: ``[B]`` true sample counts.
      device: where the work runs; the CPU only when asked for.

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
        return {
            "lip1": prep_lips(lips1_raw),
            "lip2": prep_lips(lips2_raw),
            "audio": mixed,
            "mask1": mask1,
            "mask2": mask2,
            "audio_lengths": mix_len,
        }


_PASSTHROUGH_KEYS = (
    "lip1_lengths", "lip2_lengths",
    "text1", "text1_lengths", "text2", "text2_lengths",
    "valid", "num_real",
)


def device_preprocessed_batches(raw_batches, out_size: int = 96, device="cuda"):
    """Wrap raw collated batches (``collate.collate_pairs_raw``) into the
    model's batch layout, preprocessing on ``device``."""
    for rb in raw_batches:
        proc = preprocess_batch_device(
            rb["lip1_raw"], rb["lip2_raw"], rb["audio1"], rb["audio2"],
            rb["audio1_len"], rb["audio2_len"], out_size=out_size, device=device)
        batch = {k: rb[k] for k in _PASSTHROUGH_KEYS if k in rb}
        batch.update(proc)
        yield batch
