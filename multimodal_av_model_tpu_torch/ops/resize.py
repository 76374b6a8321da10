"""cv2-compatible bilinear resize and lip-ROI preprocessing: the plain PyTorch
version and the wrapper of its CUDA kernel (K2).

Mirrors ``multimodal_av_model_tpu/ops/resize.py:21-86`` (``resize_matrix``,
the gather-based resize and ``lip_frames_preprocess``) and
``multimodal_av_model_tpu/ops/pallas/lip_kernel.py:48-84`` (the fused kernel,
here ``csrc/lip_preprocess.cu``).  OpenCV ``INTER_LINEAR`` sampling: half-pixel
centres ``src = (dst + 0.5) * scale - 0.5``, clamped at the edges.

``lip_preprocess_cuda`` is the entry the device pipeline calls.  It goes
through the operator ``mmav::lip_preprocess`` (``torch.library.custom_op``) on
every device: on a CUDA tensor the operator launches the kernel (or raises),
on a CPU tensor it takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build
from .cuda_build import SMEM_LIMIT


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


def lerp_table(out_size: int, in_size: int):
    """cv2 INTER_LINEAR source rows ``lo``, ``hi`` and weight ``frac`` (f32)
    of each output row, computed in f64: the weights of ``resize_matrix``
    and of the K2 kernel."""
    scale = in_size / out_size
    src = np.clip((np.arange(out_size) + 0.5) * scale - 0.5, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def resize_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Bilinear resize as a 2-banded matrix ``[out, in]`` (cv2 INTER_LINEAR
    weights); the plain statement of the weights the kernel lerps with."""
    lo, hi, frac = lerp_table(out_size, in_size)
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

# The source rows a band aims to stage (32 rows of a 128-wide RGB crop are 12 KB).
_BAND_SOURCE_ROWS = 32


@functools.lru_cache(maxsize=32)
def lip_band_plan(H: int, W: int, C: int, out_h: int, out_w: int, elem_bytes: int = 1):
    """Launch plan of the K2 kernel for ``[*, H, W, C]`` frames -> ``out_h x out_w``.

    Each CTA takes one frame and one band of ``rows_per_band`` output rows and
    stages source rows ``band_first[b]..band_last[b]`` of that frame: the rows
    the band's lerps read (``lerp_table``, the weights of ``resize_matrix``).  Returns
    a dict with ``rows_per_band``, ``n_bands``, ``band_first``, ``band_last``,
    the lerp tables ``ylo``, ``yhi``, ``yfrac``, ``xlo``, ``xhi``, ``xfrac``
    (numpy), ``stage_bytes`` (the staged rows, with 16 bytes for a ragged
    head, rounded to 16) and ``smem_bytes`` (that plus the x table, 3 words
    per output column, and the f32 ``[rows, out_w]`` row buffer).
    """
    n_bands = max(1, min(out_h, -(-H // _BAND_SOURCE_ROWS)))
    rows_per_band = -(-out_h // n_bands)
    n_bands = -(-out_h // rows_per_band)
    ylo, yhi, yfrac = lerp_table(out_h, H)
    xlo, xhi, xfrac = lerp_table(out_w, W)
    oy0 = np.arange(n_bands) * rows_per_band
    oy1 = np.minimum(oy0 + rows_per_band, out_h)
    band_first = np.array([ylo[a:b].min() for a, b in zip(oy0, oy1)], np.int64)
    band_last = np.array([yhi[a:b].max() for a, b in zip(oy0, oy1)], np.int64)
    rows = int((band_last - band_first + 1).max())
    stage_bytes = -(-(rows * W * C * elem_bytes + 16) // 16) * 16
    return {"rows_per_band": rows_per_band, "n_bands": n_bands,
            "band_first": band_first, "band_last": band_last,
            "ylo": ylo, "yhi": yhi, "yfrac": yfrac, "xlo": xlo, "xhi": xhi, "xfrac": xfrac,
            "stage_bytes": stage_bytes,
            "smem_bytes": stage_bytes + 3 * out_w * 4 + rows * out_w * 4}


@functools.lru_cache(maxsize=32)
def _device_tables(H: int, W: int, out_h: int, out_w: int, C: int, elem_bytes: int,
                   device: str):
    """The plan's int32 index table and f32 weight table on ``device``, in the
    order ``csrc/lip_preprocess.cu`` reads them."""
    plan = lip_band_plan(H, W, C, out_h, out_w, elem_bytes)
    idx = np.concatenate([plan[k] for k in ("ylo", "yhi", "xlo", "xhi", "band_first",
                                            "band_last")]).astype(np.int32)
    frac = np.concatenate([plan["yfrac"], plan["xfrac"]]).astype(np.float32)
    return plan, torch.from_numpy(idx).to(device), torch.from_numpy(frac).to(device)


_launch = cuda_build.Launcher("lip", "mmav_lip", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11)


def _lip_launch(frames: torch.Tensor, out_size: int) -> torch.Tensor:
    """The ``"cuda"`` kernel of ``mmav::lip_preprocess``: launches
    ``csrc/lip_preprocess.cu`` on the input as stored and counts one launch
    in ``lip_preprocess_cuda.launches``.  Raises on anything the kernel does
    not take."""
    if frames.dtype not in _SUPPORTED:
        raise TypeError(f"lip kernel: expected uint8 or float32, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("lip kernel: expected a contiguous [N, H, W, C] tensor")
    N, H, W, C = frames.shape
    if not 0 < N <= 65535 or min(H, W, C) < 1:
        raise ValueError(f"lip kernel: unsupported shape {tuple(frames.shape)}")
    plan, idx, frac = _device_tables(H, W, out_size, out_size, C, frames.element_size(),
                                     str(frames.device))
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(f"lip kernel: a band needs {plan['smem_bytes']} bytes of shared "
                         f"memory, more than {SMEM_LIMIT}")
    out = torch.empty((N, 1, out_size, out_size), dtype=torch.float32, device=frames.device)
    _launch(frames.device, lip_preprocess_cuda, frames.data_ptr(), out.data_ptr(),
            idx.data_ptr(), frac.data_ptr(), N, H, W, C, out_size, out_size,
            plan["rows_per_band"], plan["n_bands"], plan["stage_bytes"], plan["smem_bytes"],
            _SUPPORTED[frames.dtype])
    return out


# K2 as an operator (as K1 in ops/logmel.py): the CUDA kernel on the card, the
# plain version on the CPU, a fake for the output's shape, no autograd.
lip_preprocess_op = torch.library.custom_op(
    "mmav::lip_preprocess", _lip_launch, mutates_args=(), device_types="cuda",
    schema="(Tensor frames, int out_size) -> Tensor")


@lip_preprocess_op.register_kernel("cpu")
def _lip_plain(frames, out_size):
    return lip_frames_preprocess(frames, out_size)


@lip_preprocess_op.register_fake
def _lip_fake(frames, out_size):
    return frames.new_empty((frames.shape[0], 1, out_size, out_size), dtype=torch.float32)


def lip_preprocess_cuda(frames: torch.Tensor, out_size: int = 96) -> torch.Tensor:
    """K2: ``[N, H, W, C]`` (uint8 or float32, 0..255) -> ``[N, 1, out, out]``
    f32, through the operator ``mmav::lip_preprocess`` on every device.

    A CUDA tensor launches ``csrc/lip_preprocess.cu`` (counted in
    ``lip_preprocess_cuda.launches`` when it runs) or raises; a CPU tensor
    takes the plain ``lip_frames_preprocess``.
    """
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lip kernel: unsupported device {frames.device}")
    if frames.ndim != 4:
        raise ValueError("lip kernel: expected a contiguous [N, H, W, C] tensor")
    return lip_preprocess_op(frames, int(out_size))


lip_preprocess_cuda.launches = 0
