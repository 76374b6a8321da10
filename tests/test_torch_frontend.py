"""PyTorch port, frontend half: the plain versions of kernels K1 (log-mel) and
K2 (lip preprocess), mixing, on-device preprocessing, collation, tokenizer
and config, each held against its JAX counterpart on the same numpy inputs.
Runs on the CPU, where each kernel wrapper takes its plain version."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_av_model_tpu import config as jcfg
from multimodal_av_model_tpu.data import collate as jcollate
from multimodal_av_model_tpu.data.device_pipeline import preprocess_batch_device as j_preprocess
from multimodal_av_model_tpu.ops.logmel import log_mel_spectrogram as j_logmel
from multimodal_av_model_tpu.ops.pallas.lip_kernel import lip_preprocess_pallas
from multimodal_av_model_tpu.ops.pallas.logmel_kernel import log_mel_spectrogram_pallas
from multimodal_av_model_tpu.ops.resize import lip_frames_preprocess as j_lip
from multimodal_av_model_tpu.ops.resize import resize_matrix as j_resize_matrix
from multimodal_av_model_tpu.text.tokenizer import CharTokenizer as JTokenizer
from multimodal_av_model_tpu_torch import config as tcfg
from multimodal_av_model_tpu_torch.data import collate as tcollate
from multimodal_av_model_tpu_torch.data.device_pipeline import (
    device_preprocessed_batches,
    preprocess_batch_device,
)
from multimodal_av_model_tpu_torch.ops.logmel import (
    log_mel_spectrogram,
    log_mel_spectrogram_cuda,
    mel_filterbank,
    num_frames,
)
from multimodal_av_model_tpu_torch.ops.resize import (
    lip_frames_preprocess,
    lip_preprocess_cuda,
    resize_bilinear,
    resize_matrix,
)
from multimodal_av_model_tpu_torch.text import CharTokenizer

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")


def _wave(n, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    t = np.arange(n) / 16000.0
    return (0.4 * np.sin(2 * np.pi * 523 * t) + 0.1 * rng.standard_normal(shape)).astype(np.float32)


# -- K1 plain version ---------------------------------------------------------

@pytest.mark.parametrize("n", [16000, 12345])
def test_logmel_plain_matches_jax_plain(n):
    """Same STFT/mel math in both frameworks: rtol/atol 1e-4 (f32 FFTs differ
    in summation order; the log amplifies relative error only near 1e-6)."""
    x = _wave(n)
    ref = np.asarray(j_logmel(x, 16000, 400, 160, None, 80))
    got = log_mel_spectrogram(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (num_frames(n), 80)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_logmel_plain_matches_pallas_interpret():
    """K1's plain version against the Pallas kernel itself (interpret mode),
    at the kernel's own bar: rtol/atol 2e-3 (tests/test_pallas_logmel.py)."""
    x = _wave(8000, batch=3)
    ref = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(x), interpret=True))
    got = log_mel_spectrogram(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_logmel_no_log_and_short_window():
    """Raw mel power and a window shorter than n_fft (plain path only; the
    kernel refuses win_length != n_fft as the Pallas kernel asserts)."""
    x = _wave(4000)
    ref = np.asarray(j_logmel(x, apply_log=False))
    got = log_mel_spectrogram(torch.from_numpy(x), apply_log=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    ref = np.asarray(j_logmel(x, win_length=320))
    got = log_mel_spectrogram(torch.from_numpy(x), win_length=320).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_logmel_wrapper_on_cpu_takes_plain_path():
    x = torch.from_numpy(_wave(4000, batch=2))
    before = log_mel_spectrogram_cuda.launches
    np.testing.assert_array_equal(log_mel_spectrogram_cuda(x).numpy(),
                                  log_mel_spectrogram(x).numpy())
    assert log_mel_spectrogram_cuda.launches == before      # no kernel on the CPU


def test_mel_filterbank_matches_jax():
    from multimodal_av_model_tpu.ops.logmel import mel_filterbank as j_fb

    np.testing.assert_array_equal(mel_filterbank(201, 80, 16000), j_fb(201, 80, 16000))


# -- K2 plain version ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("C", [3, 1])
def test_lip_plain_matches_pallas_and_jax(dtype, C):
    """K2's plain version against the Pallas kernel (interpret) and the JAX
    gather path: rtol 1e-4, atol 1e-5 on outputs in [0, 1]."""
    rng = np.random.default_rng(C)
    frames = rng.integers(0, 256, size=(3, 128, 128, C)).astype(dtype)
    got = lip_frames_preprocess(torch.from_numpy(frames), 96).numpy()
    assert got.shape == (3, 1, 96, 96) and got.dtype == np.float32
    pallas = np.asarray(lip_preprocess_pallas(frames.astype(np.float32), 96, interpret=True))
    gather = np.asarray(j_lip(jnp.asarray(frames), 96))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, gather, rtol=1e-4, atol=1e-5)


def test_lip_plain_equals_resize_matrix_form():
    """The 2-tap lerp and the banded-matrix statement of the same weights:
    atol 1e-5, as the lerp takes its weights in f32 and the matrix in f64."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, size=(1, 50, 70, 1)).astype(np.float32)
    np.testing.assert_array_equal(resize_matrix(40, 50), j_resize_matrix(40, 50))
    want = resize_matrix(40, 50) @ img[0, :, :, 0] @ resize_matrix(30, 70).T / 255.0
    got = resize_bilinear(torch.from_numpy(img[..., 0]), 40, 30)[0].numpy() / 255.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lip_wrapper_on_cpu_and_dtype_check():
    frames = torch.zeros(2, 20, 20, 3, dtype=torch.uint8)
    before = lip_preprocess_cuda.launches
    out = lip_preprocess_cuda(frames, 8)
    assert out.shape == (2, 1, 8, 8) and lip_preprocess_cuda.launches == before
    with pytest.raises(ValueError):
        lip_preprocess_cuda(frames.to("meta"), 8)


# -- mixing + device pipeline -------------------------------------------------

def _raw_batch(B=3, T=5, HW=32, S=2400, seed=0):
    rng = np.random.default_rng(seed)
    len1 = rng.integers(S // 3, S + 1, size=B).astype(np.int32)
    len2 = rng.integers(S // 3, S + 1, size=B).astype(np.int32)
    pos = np.arange(S)[None]
    a1 = np.where(pos < len1[:, None], rng.standard_normal((B, S)), 0).astype(np.float32)
    a2 = np.where(pos < len2[:, None], rng.standard_normal((B, S)), 0).astype(np.float32)
    lips1 = rng.integers(0, 256, size=(B, T, HW, HW, 3), dtype=np.uint8)
    lips2 = rng.integers(0, 256, size=(B, T, HW, HW, 3), dtype=np.uint8)
    return lips1, lips2, a1, a2, len1, len2


def test_preprocess_batch_device_matches_jax():
    """Masks and lengths exact, mixed audio to 1e-6, lips to 1e-5 (JAX's
    matmul resize vs the port's lerp)."""
    lips1, lips2, a1, a2, len1, len2 = _raw_batch()
    ref = j_preprocess(lips1, lips2, a1, a2, len1, len2, out_size=24, use_pallas=False)
    got = preprocess_batch_device(lips1, lips2, a1, a2, len1, len2, out_size=24,
                                  device="cpu")
    assert set(got) == set(ref)
    for k in ("mask1", "mask2", "audio_lengths"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        assert got[k].dtype == torch.int32
    np.testing.assert_allclose(got["audio"].numpy(), np.asarray(ref["audio"]), atol=1e-6)
    for k in ("lip1", "lip2"):
        assert got[k].shape == (3, 5, 1, 24, 24)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5)


def test_device_preprocessed_batches_passthrough():
    lips1, lips2, a1, a2, len1, len2 = _raw_batch(B=2)
    rb = {"lip1_raw": lips1, "lip2_raw": lips2, "audio1": a1, "audio2": a2,
          "audio1_len": len1, "audio2_len": len2,
          "lip1_lengths": np.array([5, 3], np.int32), "num_real": 2}
    (batch,) = list(device_preprocessed_batches([rb], out_size=16, device="cpu"))
    assert batch["lip1_lengths"].tolist() == [5, 3] and batch["num_real"] == 2
    assert batch["lip1"].shape == (2, 5, 1, 16, 16)


def test_collate_pairs_raw_matches_jax():
    rng = np.random.default_rng(1)
    samples = [{
        "lip1_raw": rng.integers(0, 256, size=(t, 8, 8, 3), dtype=np.uint8),
        "lip2_raw": rng.integers(0, 256, size=(t + 1, 8, 8, 3), dtype=np.uint8),
        "audio1": rng.standard_normal(t * 500).astype(np.float32),
        "audio2": rng.standard_normal(t * 400).astype(np.float32),
        "label1": rng.integers(4, 50, size=3), "label2": rng.integers(4, 50, size=5),
    } for t in (4, 6)]
    spec_t = tcollate.make_bucket_specs((8,), 534, 6)[0]
    spec_j = jcollate.make_bucket_specs((8,), 534, 6)[0]
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)
    got = tcollate.collate_pairs_raw(samples, spec_t)
    ref = jcollate.collate_pairs_raw(samples, spec_j)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


# -- tokenizer + config -------------------------------------------------------

def test_tokenizer_matches_jax():
    tok, jtok = CharTokenizer(VOCAB), JTokenizer(VOCAB)
    assert (tok.blank_id, tok.unk_id, tok.pad_id, tok.vocab_size) == \
        (jtok.blank_id, jtok.unk_id, jtok.pad_id, jtok.vocab_size) == (3, 0, 0, 800)
    text = "안녕 하세요 xyz"
    assert tok.encode(text) == jtok.encode(text)
    ids = tok.encode(text) + [3, 9999, -1]
    assert tok.decode(ids) == jtok.decode(ids)


# The port's own fields, which the JAX package has not: the model selector, the
# AV-HuBERT and Whisper-Flamingo blocks it selects and the filterbank's mel
# scale (``multimodal_av_model_tpu_torch/config.py``).
PORT_ONLY = {"model.arch", "model.avhubert", "model.whisper_flamingo",
             "model.frontend.mel_scale"}


def _common_fields(t_obj, j_obj, path=""):
    """Every field of the port's config but ``PORT_ONLY`` equals the JAX
    default of that name."""
    for f in dataclasses.fields(t_obj):
        if path + f.name in PORT_ONLY:
            continue
        tv, jv = getattr(t_obj, f.name), getattr(j_obj, f.name)
        if dataclasses.is_dataclass(tv):
            _common_fields(tv, jv, f"{path}{f.name}.")
        else:
            assert tv == jv, f"{path}{f.name}: {tv!r} != {jv!r}"


def test_config_defaults_equal_jax_defaults():
    _common_fields(tcfg.Config(), jcfg.Config())
    assert tcfg.Config().model.arch == "flagship"
    cfg = tcfg.from_flat_overrides(["model.audio.num_layers=2", "decode.algorithm=greedy",
                                    "model.visual.resnet_layers=(1,1,1,1)"])
    assert cfg.model.audio.num_layers == 2 and cfg.decode.algorithm == "greedy"
    assert cfg.model.visual.resnet_layers == (1, 1, 1, 1)
    # The training fields, whose defaults are checked above with the rest.
    cfg = tcfg.from_flat_overrides(["train.audio_trainable_layers=(6,7)",
                                    "train.grad_clip_norm=1.0", "model.visual.remat=frontend",
                                    "model.audio.dropout=0.0"])
    assert cfg.train.audio_trainable_layers == (6, 7) and cfg.train.grad_clip_norm == 1.0
    assert cfg.model.visual.remat == "frontend" and cfg.model.audio.dropout == 0.0
    assert tcfg.Config().train.lr_schedule == jcfg.Config().train.lr_schedule == "constant"
    with pytest.raises(AttributeError):
        tcfg.from_flat_overrides(["model.frontend.use_pallas=true"])
    # The fields fit and the training CLI read are in the port, the
    # families', the mesh's and the compile cache's too.
    cfg = tcfg.from_flat_overrides(["train.freeze_visual_trunk=true", "train.batch_size=16",
                                    "train.checkpoint_dir=ckpt", "data.device_preprocess=false"])
    assert cfg.train.freeze_visual_trunk and cfg.train.batch_size == 16
    assert cfg.train.checkpoint_dir == "ckpt" and not cfg.data.device_preprocess
    cfg = tcfg.from_flat_overrides(["train.audio_init_ckpt=x.ckpt",
                                    "model.audio.specaug_time_masks=2"])
    assert cfg.train.audio_init_ckpt == "x.ckpt" and cfg.model.audio.specaug_time_masks == 2
    cfg = tcfg.from_flat_overrides(["mesh.fsdp=true", "mesh.model_axis=2",
                                    "compile_cache_dir=cache"])
    assert cfg.mesh.fsdp and cfg.mesh.model_axis == 2 and cfg.mesh.data_axis == -1
    assert cfg.compile_cache_dir == "cache"
    with pytest.raises(AttributeError):
        tcfg.from_flat_overrides(["mesh.pipe_axis=2"])
    # Streaming and int8 serving are ported: their fields parse.
    cfg = tcfg.from_flat_overrides(["decode.quantize=true", "decode.stream_chunk_seconds=1.0",
                                    "decode.stream_context_seconds=4.0",
                                    "decode.algorithm=reference_beam"])
    assert cfg.decode.quantize and cfg.decode.stream_chunk_seconds == 1.0
    assert cfg.decode.stream_context_seconds == 4.0
