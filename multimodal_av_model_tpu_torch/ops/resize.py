"""cv2-compatible bilinear resize and lip-ROI preprocessing: the plain PyTorch
version and the wrapper of its CUDA kernel (K2).

Mirrors ``multimodal_av_model_tpu/ops/resize.py:21-86`` (``resize_matrix``,
the gather-based resize and ``lip_frames_preprocess``) and
``multimodal_av_model_tpu/ops/pallas/lip_kernel.py:48-84`` (the fused kernel,
here ``csrc/lip_preprocess.cu``).  OpenCV ``INTER_LINEAR`` sampling: half-pixel
centres ``src = (dst + 0.5) * scale - 0.5``, clamped at the edges.

``lip_preprocess_cuda`` is the entry the device pipeline calls: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build


def _lerp_weights(out_size: int, in_size: int, device):
    scale = in_size / out_size
    src = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    src = src.clamp(0.0, in_size - 1)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=in_size - 1)
    frac = src - lo.to(torch.float32)
    return lo, hi, frac


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize over the last two axes with cv2 INTER_LINEAR semantics."""
    in_h, in_w = images.shape[-2], images.shape[-1]
    ylo, yhi, yfrac = _lerp_weights(out_h, in_h, images.device)
    xlo, xhi, xfrac = _lerp_weights(out_w, in_w, images.device)
    top = images.index_select(-2, ylo)
    bot = images.index_select(-2, yhi)
    rows = top + (bot - top) * yfrac[:, None]
    left = rows.index_select(-1, xlo)
    right = rows.index_select(-1, xhi)
    return left + (right - left) * xfrac


def resize_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Bilinear resize as a 2-banded matrix ``[out, in]`` (cv2 INTER_LINEAR
    weights); the plain statement of the weights the kernel lerps with."""
    scale = in_size / out_size
    src = np.clip((np.arange(out_size) + 0.5) * scale - 0.5, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), lo] += 1.0 - frac
    m[np.arange(out_size), hi] += frac
    return m


def lip_frames_preprocess(frames: torch.Tensor, out_size: int = 96) -> torch.Tensor:
    """Plain version of K2: ``[N, H, W, C]`` uint8/float in 0..255 ->
    ``[N, 1, out, out]`` float32 (channel mean -> resize -> /255)."""
    gray = frames.to(torch.float32).mean(dim=-1)
    return (resize_bilinear(gray, out_size, out_size) / 255.0)[:, None]


_SUPPORTED = {torch.uint8: 1, torch.float32: 0}


@functools.lru_cache(maxsize=1)
def _library():
    """The built kernel library and its launch function, typed."""
    lib = cuda_build.load("lip")
    launch = lib.mmav_lip_launch
    launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return lib, launch


def lip_preprocess_cuda(frames: torch.Tensor, out_size: int = 96) -> torch.Tensor:
    """K2: ``[N, H, W, C]`` (uint8 or float32, 0..255) -> ``[N, 1, out, out]`` f32.

    A CUDA tensor launches ``csrc/lip_preprocess.cu`` on the input as stored
    and counts one launch in ``lip_preprocess_cuda.launches``; a CPU tensor
    takes the plain ``lip_frames_preprocess``.  Raises on anything the kernel
    does not take.
    """
    if frames.device.type == "cpu":
        return lip_frames_preprocess(frames, out_size)
    if frames.device.type != "cuda":
        raise ValueError(f"lip kernel: unsupported device {frames.device}")
    if frames.dtype not in _SUPPORTED:
        raise TypeError(f"lip kernel: expected uint8 or float32, got {frames.dtype}")
    if frames.ndim != 4 or not frames.is_contiguous():
        raise ValueError("lip kernel: expected a contiguous [N, H, W, C] tensor")
    N, H, W, C = frames.shape
    if not 0 < N <= 65535 or min(H, W, C) < 1:
        raise ValueError(f"lip kernel: unsupported shape {tuple(frames.shape)}")
    out = torch.empty((N, 1, out_size, out_size), dtype=torch.float32, device=frames.device)
    lib, launch = _library()
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    code = launch(frames.data_ptr(), out.data_ptr(), N, H, W, C, out_size, out_size,
                  _SUPPORTED[frames.dtype], stream)
    cuda_build.check_launch(lib, "mmav_lip", code)
    lip_preprocess_cuda.launches += 1
    return out


lip_preprocess_cuda.launches = 0
