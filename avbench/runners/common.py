"""What the runners share: the system's model on seeded weights, and the
reference's set-up after the program is freed."""

from __future__ import annotations

import contextlib
import gc

from .. import roofline, weights


def meta_model(ctx):
    """The system's ``MultiSpeakerAVModel`` of ``ctx.config``, on the meta device."""
    import torch

    from multimodal_av_model_tpu_torch.config import torch_dtype
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel

    with torch.device("meta"):
        return MultiSpeakerAVModel(ctx.config.model, torch_dtype(ctx.config.model.dtype))


def template(ctx) -> dict:
    """The names, shapes and dtypes of the system's state dict (meta tensors)."""
    return dict(meta_model(ctx).state_dict())


def seeded_model(ctx):
    """The system's model on ``ctx.device`` with the weights of ``ctx.seed``;
    -> ``(model, template)``."""
    model = meta_model(ctx)
    template = dict(model.state_dict())
    model = model.to_empty(device=ctx.device)
    model.load_state_dict(weights.seeded_state_dict(template, ctx.seed, ctx.device), strict=True)
    return model, template


def sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def free(device: str) -> None:
    import torch

    gc.collect()
    sync(device)
    if device == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def full_f32():
    """TF32 off for matrix products and convolutions (the reference's precision)."""
    import torch

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def shapes(mix: dict) -> tuple[int, int, int]:
    """``(B, frames, samples)`` of the traffic's batches."""
    return mix["batch"], mix["bucket"], mix["bucket"] * mix["audio_samples_per_frame"]


def kernel_work(mix: dict, fe: dict) -> dict:
    """Least work of one launch of each kernel with a roofline share at the
    traffic's shapes: K1 on the ``[B, S]`` mixture."""
    B, _, S = shapes(mix)
    return {"logmel_kernel": roofline.k1(B, S, fe)}


def launches():
    from multimodal_av_model_tpu_torch.ops.logmel import log_mel_spectrogram_cuda
    from multimodal_av_model_tpu_torch.ops.resize import lip_preprocess_cuda

    return {"logmel": log_mel_spectrogram_cuda.launches,
            "lip_preprocess": lip_preprocess_cuda.launches}


