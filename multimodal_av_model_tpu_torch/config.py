"""Typed configuration tree of the two-speaker serving and training run.

Mirrors ``multimodal_av_model_tpu/config.py:18-363``, restricted to the
fields the serving path, the training runs (``fit`` of every family, the
data pipeline) and the port's CLI read.  Every default equals the JAX
default.  Dropped on purpose:

* ``frontend.use_pallas`` (``config.py:32``): the port picks the kernel or
  its plain version by the tensor's device alone;
* ``train.keep_checkpoints`` (``config.py:284``), ``frontend.power``
  (``:31``), ``audio.max_len`` (``:56``), ``visual.image_size`` (``:82``)
  and ``decoder.input_dim`` (``:121``): nothing reads them, in either
  package, so an override of one fails as an unknown field rather than
  parsing and doing nothing;
* nothing else: the mesh (``MeshConfig``) and ``compile_cache_dir`` are the
  JAX fields, read by the port's CLI (``main.py``).
"""

from __future__ import annotations

import dataclasses
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
    dropout: float = 0.1              # FFN, conv-module and attention-weight sites
    subsample_factor: int = 2
    middle_layers: tuple[int, ...] = (6, 7, 8, 9)
    output_dim: int = 1024
    # SpecAugment on the log-mel in train mode (ops/specaugment.py,
    # config.py:57-62); off by default.
    specaug_freq_masks: int = 0
    specaug_freq_width: int = 27
    specaug_time_masks: int = 0
    specaug_time_frac: float = 0.05


@dataclass
class VisualEncoderConfig:
    """Time-folded frontend + per-frame ResNet-18 (``config.py:65-92``)."""

    frontend_channels: int = 64
    resnet_layers: tuple[int, ...] = (2, 2, 2, 2)
    resnet_channels: tuple[int, ...] = (64, 128, 256, 512)
    norm: str = "batch"               # "batch" or "group"
    activation: str = "prelu"         # "prelu" or "relu"
    output_dim: int = 512
    # Recomputation in the backward (config.py:83-92): "none", "frontend"
    # (the frontend conv + norm + act + pool), "stage1" (also the ResNet
    # stage-1 blocks) or "full" (the whole encoder).
    remat: str = "none"


@dataclass
class FusionConfig:
    """Cross-attention fusion + temporal model (``config.py:95-106``)."""

    fused_dim: int = 512
    num_heads: int = 4
    temporal_model: str = "bilstm"    # "bilstm" or "transformer"
    temporal_layers: int = 2
    transformer_heads: int = 8
    transformer_ffn_dim: int = 2048


@dataclass
class ContrastiveConfig:
    """Masked contrastive loss (``config.py:110-116``)."""

    temperature: float = 0.07
    weight_pos_align: float = 1.0
    weight_neg_suppress: float = 0.3
    projection_dim: int = 128


@dataclass
class DecoderConfig:
    """CTC head (``config.py:120-123``); its input width is 2 * fused_dim."""

    vocab_size: int = 800
    blank_id: int = 3


@dataclass
class DecodeConfig:
    """Decoding, streaming and int8 serving (``config.py:126-152``).

    ``algorithm``: "prefix_beam" (CTC prefix search), "reference_beam" (the
    path beam, collapsed at the end) or "greedy"."""

    beam_width: int = 5
    algorithm: str = "prefix_beam"
    prefix_top_k: int = 8
    lm_path: str = ""                 # bigram table (.npy, [V+1, V] log-probs)
    lm_weight: float = 0.3
    length_bonus: float = 0.0
    # Streaming (streaming.py): emission granularity and the already-seen
    # audio the encoder attends over per chunk.
    stream_chunk_seconds: float = 2.0
    stream_context_seconds: float = 8.0
    # Serve with per-channel int8 weights (ops/quantize.py): --infer, --stream
    # and AudioTranscriber; training is never quantized.
    quantize: bool = False


@dataclass
class AVHubertConfig:
    """AV-HuBERT's early-fusion encoder with a CTC head (``model.arch =
    "avhubert"``; facebookresearch/av_hubert ``avhubert/hubert.py``
    ``AVHubertModel``, ``hubert_asr.py``; arXiv:2201.02184).  Defaults are
    AV-HuBERT Large.  The model also reads ``frontend`` (K1: AV-HuBERT's 26
    filterbank bins take ``n_mels=26, center=False``), ``visual`` (the
    ResNet-18 trunk; its ``output_dim`` is ``embed_dim``: the trunk's
    ``Linear(512 -> 1024)`` is AV-HuBERT's video projection), ``decoder`` and
    ``dtype``.  Four filterbank frames of ``hop_length`` samples make one
    video frame, so ``data.audio_samples_per_video_frame`` should be ``4 *
    hop_length`` (640: 25 fps)."""

    embed_dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    conv_pos: int = 128               # positional convolution's kernel (even: SamePad)
    conv_pos_groups: int = 16
    # Train-mode dropout (fairseq's sites): ``dropout`` on the layers' input and
    # after each attention and FFN, ``attention_dropout`` on the attention
    # weights, ``activation_dropout`` after the FFN's GELU.
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0


@dataclass
class ModelConfig:
    frontend: AudioFrontendConfig = field(default_factory=AudioFrontendConfig)
    audio: AudioEncoderConfig = field(default_factory=AudioEncoderConfig)
    visual: VisualEncoderConfig = field(default_factory=VisualEncoderConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    contrastive: ContrastiveConfig = field(default_factory=ContrastiveConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    dtype: str = "bfloat16"           # activation dtype; params stay float32
    # True: encode the mixture once for both speakers (exact in eval; in
    # training they share one dropout draw).  False: the reference-shaped
    # double pass, the encoder on [2B] rows, each with its own speaker's
    # mask (``config.py:164-171``).
    shared_audio_pass: bool = True
    # Which two-speaker model the entry points build (models/av_model.py:
    # build_av_model): "flagship" (MultiSpeakerAVModel) or "avhubert"
    # (models/avhubert.py, configured by ``avhubert``).
    arch: str = "flagship"
    avhubert: AVHubertConfig = field(default_factory=AVHubertConfig)


def require_flagship(model: "ModelConfig | None", what: str) -> None:
    """Raise for ``what``, a path that only the flagship model has, when
    ``model`` selects another ``arch``."""
    if model is not None and model.arch != "flagship":
        raise ValueError(f"{what} runs the flagship model only; model.arch={model.arch!r} "
                         "trains (train_step, evaluate) and transcribes (Transcriber) on one "
                         "device")


@dataclass
class DataConfig:
    """The AI-Hub corpus layout, pair sampling and bucketing (``config.py:174-197``)."""

    json_folder: str = "input_texts"
    npy_dir: str = "npy"
    text_dir: str = "processed_dataset/text"
    wav_dir: str = "input_wav/input_wav"
    vocab_path: str = "assets/tokenizer800.vocab"
    sample_rate: int = 16000
    num_pairs_per_epoch: int = 10000
    eval_pairs: int = 500
    video_buckets: tuple[int, ...] = (64, 128, 256, 448)
    audio_samples_per_video_frame: int = 534
    max_label_len: int = 128
    prefetch_depth: int = 2
    # Raw uint8 crops and per-speaker waveforms go to the device, where
    # mixing and K2 run (data/device_pipeline.py); False preprocesses on the
    # host (FilePairSource.load_pair).
    device_preprocess: bool = True
    seed: int = 42


@dataclass
class TrainConfig:
    """The training step, its optimizer, ``fit`` and the training CLI of every
    family (``config.py:201-284``)."""

    batch_size: int = 8
    eval_batch_size: int = 4
    learning_rate: float = 1e-4
    audio_learning_rate: float = 2e-5
    lambda_contrastive: float = 0.1
    contrastive_only: bool = False    # optimise the contrastive loss alone
    max_epochs: int = 50
    early_stop_patience: int = 5
    freeze_visual_trunk: bool = False # -> frozen_prefixes=("visual_encoder",)
    visual_init_ckpt: str = ""        # a port checkpoint whose visual encoder is grafted in
    audio_init_ckpt: str = ""         # an SSL (--family=ssl) checkpoint whose audio encoder is grafted in
    ssl_mask_prob: float = 0.065      # span-mask start probability (config.py:228-230)
    ssl_mask_span: int = 10           # span length in encoder frames
    ssl_temperature: float = 0.1      # masked-InfoNCE temperature
    # None: the whole audio encoder trains at audio_learning_rate; a tuple
    # freezes the audio encoder except those Conformer blocks.
    audio_trainable_layers: tuple[int, ...] | None = None
    lr_schedule: str = "constant"     # "constant", "warmup_cosine" or "noam"
    warmup_steps: int = 1000
    decay_steps: int = 50000
    lr_min_ratio: float = 0.0
    grad_accum_steps: int = 1         # k micro-batches averaged into one update
    grad_clip_norm: float | None = None   # per optimizer group
    check_finite: bool = True         # raise on non-finite metrics
    async_dispatch: bool = True       # fold metrics on the device, sync at log points
    checkpoint_dir: str = "checkpoints"
    checkpoint_layout: str = "file"   # or "sharded": DCP directories (train/sharded_checkpoints.py)
    async_checkpoint: bool = False    # snapshot to host, then write on a background thread
    handle_signals: bool = True       # SIGTERM/SIGINT in fit -> save last.ckpt and return
    tensorboard_dir: str = ""         # per-epoch scalars (tensorboardX, no-op if absent)
    log_every: int = 100


@dataclass
class MeshConfig:
    """The ``(data, model)`` mesh of a ``torchrun`` training run
    (``config.py:287-300``)."""

    data_axis: int = -1               # -1: every rank not on ``model``; else checked
    model_axis: int = 1               # tensor-parallel ranks (parallel/tp.py)
    fsdp: bool = False                # shard parameters and Adam over data (parallel/fsdp.py)


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    compile_cache_dir: str = ""       # non-empty: build K1, K2 and the host ops there
                                      # and reuse them (runtime/compile_cache.py)


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
    elif current is None:                 # as config.py:341-349
        if raw.lower() == "none":
            value = None
        elif raw.lower() in ("true", "false", "yes", "no", "on", "off"):
            value = raw.lower() in ("true", "yes", "on")
        elif raw.startswith("("):
            value = tuple(int(x) for x in raw.strip("()").split(",") if x)
        else:
            value = float(raw)
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


def to_dict(cfg: Any) -> dict:
    """The configuration tree as nested dicts (``config.py:366-367``)."""
    return dataclasses.asdict(cfg)
