"""Visual (lipreading) encoder: time-folded conv frontend + per-frame ResNet-18.

Mirrors ``multimodal_av_model_tpu/models/visual.py:27-139``.  The
Conv3D frontend (kernel (5,7,7), temporal stride 1) is the JAX package's
time-folded 2D convolution: the 5 temporal taps become the input channels of a
7x7 conv over the ``B*T`` frame batch (tap k of channel c is input channel
``k*C + c`` and reads frame ``t + k - 2``).  The flax HWIO kernel
``[7,7,5,64]`` is this conv's OIHW ``[64,5,7,7]``.  The max-pool pads with
-inf.  Inside, the tensors are NCHW by shape; the public input stays the JAX
``[B, T, H, W, C]``.  In a 16-bit compute dtype the trunk keeps its
activations channels_last (NHWC in memory) from the tap stack to the mean
pool, the layout cuDNN's bf16 and f16 convolutions run in, so nothing inside
converts them; f32 and f64 stay NCHW (``memory_format``).  ``train`` selects
batch statistics in the BatchNorms
(and updates their running statistics); ``config.remat`` recomputes part of
the encoder in the backward (``visual.py:60-73,123-130``,
``av_model.py:49-62``), the running statistics still updating once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VisualEncoderConfig
from .layers import Dense, _param, make_act, make_norm, remat

REMAT_MODES = ("none", "frontend", "stage1", "full")


def memory_format(dtype: torch.dtype) -> torch.memory_format:
    """The trunk's layout in compute dtype ``dtype``: channels_last for bf16
    and f16, NCHW for f32 and f64."""
    return torch.channels_last if dtype in (torch.bfloat16, torch.float16) \
        else torch.contiguous_format


def tap_stack(lips, taps: int, dtype: torch.dtype):
    """``[B, T, H, W, C]`` -> ``[B*T, taps*C, H, W]`` in ``dtype`` and its
    ``memory_format``: input channel ``k*C + c`` is channel c of frame
    ``t + k - taps // 2``, zeros past either end of the clip.  The taps are
    concatenated on the last axis, so the stack is made channels_last in the
    one copy; f32 and f64 take one more, to NCHW."""
    B, T, H, W, C = lips.shape
    pad = taps // 2
    xp = F.pad(lips.to(dtype), (0, 0, 0, 0, 0, 0, pad, pad))   # zero frames at both ends
    x = torch.cat([xp[:, k:k + T] for k in range(taps)], dim=-1)  # [B, T, H, W, taps*C]
    x = x.reshape(B * T, H, W, taps * C).permute(0, 3, 1, 2)
    return x.contiguous(memory_format=memory_format(dtype))


class Conv2d(nn.Module):
    """Bias-free 2D conv with f32 weights, computed in ``dtype``; the weight
    is cast to ``dtype`` and the trunk's ``memory_format`` in one copy."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, padding: int,
                 dtype: torch.dtype):
        super().__init__()
        self.weight = _param(out_ch, in_ch, kernel, kernel)
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        w = self.weight.to(self.dtype, memory_format=memory_format(self.dtype))
        return F.conv2d(x, w, None, self.stride, self.padding)


class BasicBlock(nn.Module):
    """ResNet BasicBlock with two activation sites (``visual.py:27-49``)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, norm: str, activation: str,
                 dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out_ch, 3, stride, 1, dtype)
        self.norm1 = make_norm(norm, out_ch, dtype)
        self.act1 = make_act(activation, out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, 1, 1, dtype)
        self.norm2 = make_norm(norm, out_ch, dtype)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(Conv2d(in_ch, out_ch, 1, stride, 0, dtype),
                                            make_norm(norm, out_ch, dtype))
        self.act2 = make_act(activation, out_ch)

    def forward(self, x, train: bool = False):
        h = self.act1(self.norm1(self.conv1(x), train))
        h = self.norm2(self.conv2(h), train)
        identity = x
        if self.downsample is not None:
            conv, norm = self.downsample
            identity = norm(conv(x), train)
        return self.act2(h + identity)


class ResNetTrunk(nn.Module):
    """Per-frame ResNet-18 trunk with a global mean pool (``visual.py:52-74``)."""

    def __init__(self, in_ch: int, layers, channels, norm: str, activation: str,
                 dtype: torch.dtype):
        super().__init__()
        blocks = []
        for stage, (n_blocks, feats) in enumerate(zip(layers, channels)):
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(BasicBlock(in_ch, feats, stride, norm, activation, dtype))
                in_ch = feats
        self.blocks = nn.ModuleList(blocks)
        self.stage1_blocks = layers[0]

    def forward(self, x, train: bool = False, remat_stage1: bool = False):
        for i, block in enumerate(self.blocks):
            if remat_stage1 and i < self.stage1_blocks:
                x = remat(block, [block], x, train)
            else:
                x = block(x, train)
        return x.mean(dim=(2, 3))


class VisualEncoder(nn.Module):
    """``[B, T, H, W, C] -> [B, T, output_dim]`` lip-clip encoder."""

    time_taps = 5

    def __init__(self, config: VisualEncoderConfig, dtype: torch.dtype = torch.float32,
                 in_channels: int = 1):
        super().__init__()
        cfg = config
        if cfg.remat not in REMAT_MODES:
            raise ValueError(f"unknown visual.remat {cfg.remat!r}")
        self.config, self.dtype = config, dtype
        c0 = cfg.frontend_channels
        self.frontend_conv = Conv2d(in_channels * self.time_taps, c0, 7, 2, 3, dtype)
        self.frontend_norm = make_norm(cfg.norm, c0, dtype)
        self.frontend_act = make_act(cfg.activation, c0)
        self.trunk = ResNetTrunk(c0, cfg.resnet_layers, cfg.resnet_channels, cfg.norm,
                                 cfg.activation, dtype)
        self.proj = None
        if cfg.resnet_channels[-1] != cfg.output_dim:
            self.proj = Dense(cfg.resnet_channels[-1], cfg.output_dim, dtype=dtype)

    def forward(self, lips, train: bool = False):
        mode = self.config.remat if torch.is_grad_enabled() else "none"
        if mode == "full":
            return remat(self._forward, [self], lips, train, "none")
        return self._forward(lips, train, mode)

    def _frontend(self, x, train: bool):
        x = self.frontend_act(self.frontend_norm(self.frontend_conv(x), train))
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)

    def _forward(self, lips, train: bool, mode: str):
        B, T = lips.shape[:2]
        x = tap_stack(lips, self.time_taps, self.dtype)
        if mode in ("frontend", "stage1"):
            x = remat(self._frontend, [self.frontend_norm], x, train)
        else:
            x = self._frontend(x, train)
        x = self.trunk(x, train, remat_stage1=(mode == "stage1")).reshape(B, T, -1)
        return x if self.proj is None else self.proj(x)
