"""Typed configuration tree of the serving slice.

Mirrors ``multimodal_av_model_tpu/config.py:18-363``, restricted to the
fields the two-speaker serving path reads.  Every default equals the JAX
default.  Dropped on purpose:

* ``frontend.use_pallas`` (``config.py:32``): the port picks the kernel or
  its plain version by the tensor's device alone;
* ``model.shared_audio_pass`` (``config.py:171``): the port always encodes
  the mixture once, which is exact in eval;
* training, mesh and streaming fields, which belong to later slices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass
class AudioFrontendConfig:
    """STFT -> log-mel frontend (``config.py:18-37``)."""

    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    win_length: int = 400
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float | None = None        # None -> sample_rate / 2
    log_eps: float = 1e-6
    center: bool = True


@dataclass
class AudioEncoderConfig:
    """Log-mel Conformer (``config.py:40-62``)."""

    d_model: int = 512
    num_layers: int = 12
    num_heads: int = 8
    ffn_dim: int = 2048
    conv_kernel_size: int = 15
    subsample_factor: int = 2
    middle_layers: tuple[int, ...] = (6, 7, 8, 9)
    output_dim: int = 1024


@dataclass
class VisualEncoderConfig:
    """Time-folded frontend + per-frame ResNet-18 (``config.py:65-92``)."""

    frontend_channels: int = 64
    resnet_layers: tuple[int, ...] = (2, 2, 2, 2)
    resnet_channels: tuple[int, ...] = (64, 128, 256, 512)
    norm: str = "batch"               # "batch" or "group"
    activation: str = "prelu"         # "prelu" or "relu"
    output_dim: int = 512


@dataclass
class FusionConfig:
    """Cross-attention fusion + temporal model (``config.py:95-106``)."""

    fused_dim: int = 512
    num_heads: int = 4
    temporal_model: str = "bilstm"    # the port has the BiLSTM only so far
    temporal_layers: int = 2


@dataclass
class ContrastiveConfig:
    projection_dim: int = 128         # config.py:116


@dataclass
class DecoderConfig:
    """CTC head (``config.py:120-123``); its input width is 2 * fused_dim."""

    vocab_size: int = 800
    blank_id: int = 3


@dataclass
class DecodeConfig:
    """Decoder choice (``config.py:126-152``): "prefix_beam" or "greedy"."""

    beam_width: int = 5
    algorithm: str = "prefix_beam"
    prefix_top_k: int = 8
    lm_path: str = ""                 # bigram table (.npy, [V+1, V] log-probs)
    lm_weight: float = 0.3
    length_bonus: float = 0.0


@dataclass
class ModelConfig:
    frontend: AudioFrontendConfig = field(default_factory=AudioFrontendConfig)
    audio: AudioEncoderConfig = field(default_factory=AudioEncoderConfig)
    visual: VisualEncoderConfig = field(default_factory=VisualEncoderConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    contrastive: ContrastiveConfig = field(default_factory=ContrastiveConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    dtype: str = "bfloat16"           # activation dtype; params stay float32


@dataclass
class DataConfig:
    """Bucketing of the serving batches (``config.py:174-197``)."""

    vocab_path: str = "assets/tokenizer800.vocab"
    video_buckets: tuple[int, ...] = (64, 128, 256, 448)
    audio_samples_per_video_frame: int = 534
    max_label_len: int = 128


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)


def _set_dotted(obj: Any, path: str, raw: str) -> None:
    parts = path.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    name = parts[-1]
    if not hasattr(obj, name):
        raise AttributeError(f"unknown config field: {path}")
    current = getattr(obj, name)
    value: Any
    if isinstance(current, bool):
        value = raw.lower() in ("1", "true", "yes", "on")
    elif isinstance(current, int):
        value = int(raw)
    elif isinstance(current, float):
        value = float(raw)
    elif isinstance(current, tuple):
        value = tuple(int(x) for x in raw.strip("()").split(",") if x)
    elif current is None:
        value = None if raw.lower() == "none" else float(raw)
    else:
        value = raw
    setattr(obj, name, value)


def from_flat_overrides(overrides: Sequence[str], base: Config | None = None) -> Config:
    """Build a Config from ``key.path=value`` strings (``config.py:355-363``)."""
    cfg = base if base is not None else Config()
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must look like a.b.c=value, got {item!r}")
        path, raw = item.split("=", 1)
        _set_dotted(cfg, path.strip(), raw.strip())
    return cfg


def torch_dtype(name: str):
    """``ModelConfig.dtype`` name -> torch dtype."""
    import torch

    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"unknown model dtype {name!r}")
    return dtypes[name]
