"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip where there is no CUDA device (the decision is made
in the fixture, at run time).  On a machine with the card:

    python -m pytest tests/test_torch_kernels.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from multimodal_av_model_tpu_torch.ops.logmel import (
    log_mel_spectrogram,
    log_mel_spectrogram_cuda,
    logmel_plan,
)
from multimodal_av_model_tpu_torch.ops.resize import (
    lip_band_plan,
    lip_frames_preprocess,
    lip_preprocess_cuda,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain version in full f32
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(4, 68352), (3, 12345), (1, 4000), (16000,)])
def test_logmel_kernel_matches_plain(cuda, shape):
    """Bar of tests/test_pallas_logmel.py: rtol = atol = 2e-3."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32)).to(cuda)
    before = log_mel_spectrogram_cuda.launches
    got = log_mel_spectrogram_cuda(x)
    torch.cuda.synchronize()
    assert log_mel_spectrogram_cuda.launches == before + 1
    ref = log_mel_spectrogram(x)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)
    raw = log_mel_spectrogram_cuda(x, apply_log=False)
    torch.testing.assert_close(raw, log_mel_spectrogram(x, apply_log=False),
                               rtol=2e-3, atol=1e-2)


@pytest.mark.parametrize("shape,center", [((1, 201), True), ((1, 400), False),
                                          ((2, 400 + 160 * 20), False)])
def test_logmel_kernel_edge_lengths(cuda, shape, center):
    """The shortest centred input (S = 201, T = 2), one frame without centring
    (S = 400, T = 1) and a partial last m-tile, with and without the log."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32)).to(cuda)
    for apply_log, atol in ((True, 2e-3), (False, 1e-2)):
        got = log_mel_spectrogram_cuda(x, center=center, apply_log=apply_log)
        ref = log_mel_spectrogram(x, center=center, apply_log=apply_log)
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, rtol=2e-3, atol=atol)


def test_logmel_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 4000, device=cuda)
    with pytest.raises(TypeError):
        log_mel_spectrogram_cuda(x.double())
    with pytest.raises(ValueError):
        log_mel_spectrogram_cuda(x, win_length=320)
    with pytest.raises(ValueError):
        log_mel_spectrogram_cuda(torch.zeros(4000, 2, device=cuda).t())


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape,out", [((512, 128, 128, 3), 96), ((7, 50, 70, 1), 96),
                                       ((5, 128, 128, 3), 40), ((3, 37, 53, 3), 96),
                                       ((3, 37, 53, 4), 96)])
def test_lip_kernel_matches_plain(cuda, dtype, shape, out):
    """Bar of tests/test_lip_kernel.py: rtol 1e-4, atol 1e-3.  C = 1 and 3 take
    the kernel's fixed channel counts, C = 4 its run-time one."""
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.uint8))
    frames = frames.to(device=cuda, dtype=dtype)
    before = lip_preprocess_cuda.launches
    got = lip_preprocess_cuda(frames, out)
    torch.cuda.synchronize()
    assert lip_preprocess_cuda.launches == before + 1
    torch.testing.assert_close(got, lip_frames_preprocess(frames, out), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("shape,out", [((7, 50, 70, 1), 96), ((3, 37, 53, 3), 96),
                                       ((3, 37, 53, 4), 96)])
def test_lip_kernel_unaligned_base(cuda, dtype, shape, out):
    """A view that starts one frame into a larger buffer (a narrow along N, still
    contiguous): frames of 3,500, 5,883 and 7,844 bytes, so no 16-byte alignment.
    C = 4 takes the kernel's run-time channel count."""
    rng = np.random.default_rng(4)
    big = torch.from_numpy(rng.integers(0, 256, size=(shape[0] + 1,) + shape[1:]).astype(np.uint8))
    frames = big.to(device=cuda, dtype=dtype).narrow(0, 1, shape[0])
    assert frames.is_contiguous() and frames.storage_offset() > 0
    got = lip_preprocess_cuda(frames, out)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lip_frames_preprocess(frames, out), rtol=1e-4, atol=1e-3)


def test_launches_above_48kb_of_shared_memory(cuda):
    """Both kernels opt in to more than 48 KB of dynamic shared memory: K1 at
    every shape, K2 for float32 crops at the serving shape."""
    assert logmel_plan(4, 68352)["smem_bytes"] > 48 * 1024
    assert lip_band_plan(128, 128, 3, 96, 96, 4)["smem_bytes"] > 48 * 1024
    rng = np.random.default_rng(6)
    x = torch.from_numpy((0.3 * rng.standard_normal((4, 68352))).astype(np.float32)).to(cuda)
    torch.testing.assert_close(log_mel_spectrogram_cuda(x), log_mel_spectrogram(x),
                               rtol=2e-3, atol=2e-3)
    frames = torch.from_numpy(rng.integers(0, 256, size=(16, 128, 128, 3)).astype(np.float32))
    frames = frames.to(cuda)
    torch.testing.assert_close(lip_preprocess_cuda(frames), lip_frames_preprocess(frames),
                               rtol=1e-4, atol=1e-3)


def test_lip_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        lip_preprocess_cuda(torch.zeros(2, 8, 8, 3, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        lip_preprocess_cuda(torch.zeros(2, 8, 8, 3, device=cuda).permute(0, 2, 1, 3))
