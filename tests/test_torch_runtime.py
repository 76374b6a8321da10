"""PyTorch port, the runtime and CLI tools: the native host ops against the
JAX package's on the same seeded inputs (at ``tests/test_runtime_native.py``'s
tolerances), the build-failure path, ``compile_cache_dir``, ``trace``,
``annotate`` and ``nan_guard`` on a tiny CPU model, and the tokenizer's
``decode_ctc``, ``encode_array`` and vocab builders against JAX's (the vocab
files byte for byte).  CPU only.
"""

import glob
import os

import numpy as np
import pytest
import torch

from multimodal_av_model_tpu.data.pipeline import preprocess_lip_clip_host as j_preprocess
from multimodal_av_model_tpu.ops.metrics import levenshtein as j_levenshtein
from multimodal_av_model_tpu.runtime import native as jnative
from multimodal_av_model_tpu.text import tokenizer as jtokenizer
from multimodal_av_model_tpu_torch.data.pipeline import preprocess_lip_clip_host
from multimodal_av_model_tpu_torch.ops import cuda_build
from multimodal_av_model_tpu_torch.ops.metrics import cer_counts, levenshtein
from multimodal_av_model_tpu_torch.runtime import compile_cache, native
from multimodal_av_model_tpu_torch.text import tokenizer as ptokenizer
from multimodal_av_model_tpu_torch.train import profiling

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")


def test_the_library_builds_here():
    assert native.have_native()
    assert os.path.isfile(native.library_path())


def test_native_ops_equal_their_numpy_paths():
    rng = np.random.default_rng(6)
    pcm = rng.integers(-32768, 32767, size=4800).astype(np.int16)
    np.testing.assert_allclose(native.pcm16_to_f32(pcm, 2), native.pcm16_to_f32_numpy(pcm, 2),
                               atol=1e-7)
    x = rng.standard_normal(4800).astype(np.float32)
    np.testing.assert_allclose(native.resample_linear(x, 48000, 16000),
                               native.resample_linear_numpy(x, 48000, 16000), atol=1e-6)
    clip = rng.uniform(0, 255, size=(5, 128, 128)).astype(np.float32)
    np.testing.assert_allclose(native.resize_bilinear(clip, 96, 96),
                               native.resize_bilinear_numpy(clip, 96, 96), rtol=1e-5, atol=1e-3)
    for got, want in zip(native.mix_and_mask(x, x[:3000]),
                         native.mix_and_mask_numpy(x, x[:3000])):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert native.levenshtein([1, 2, 3], [2, 3]) == native.levenshtein_numpy([1, 2, 3], [2, 3])


@pytest.mark.parametrize("a,b", [("kitten", "sitting"), ("", "abc"), ("같다", "같다")])
def test_levenshtein_matches_jax(a, b):
    assert native.levenshtein(a, b) == jnative.levenshtein(a, b)


def test_levenshtein_of_tokens_matches_jax():
    rng = np.random.default_rng(0)
    words = ["가", "나다", "라", "마바사", "a"]
    for _ in range(20):
        a = [words[i] for i in rng.integers(0, 5, size=rng.integers(0, 30))]
        b = [words[i] for i in rng.integers(0, 5, size=rng.integers(0, 30))]
        assert levenshtein(a, b) == j_levenshtein(a, b)
    assert cer_counts(["가나 다"], ["가다"]) == (2, 4)


def test_resize_matches_jax():
    imgs = np.random.default_rng(1).uniform(0, 255, size=(3, 128, 128)).astype(np.float32)
    np.testing.assert_allclose(native.resize_bilinear(imgs, 96, 96),
                               jnative.resize_bilinear(imgs, 96, 96), rtol=1e-5, atol=1e-3)
    crops = np.random.default_rng(5).integers(0, 256, size=(4, 128, 128, 3), dtype=np.uint8)
    np.testing.assert_allclose(preprocess_lip_clip_host(crops), j_preprocess(crops),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channels", [1, 2])
def test_pcm16_matches_jax(channels):
    pcm = np.random.default_rng(2).integers(-32768, 32767, size=1000).astype(np.int16)
    np.testing.assert_allclose(native.pcm16_to_f32(pcm, channels),
                               jnative.pcm16_to_f32(pcm, channels), atol=1e-7)


def test_mix_and_mask_matches_jax():
    rng = np.random.default_rng(3)
    a1 = rng.standard_normal(100).astype(np.float32)
    a2 = rng.standard_normal(60).astype(np.float32)
    for got, want in zip(native.mix_and_mask(a1, a2), jnative.mix_and_mask(a1, a2)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rates", [(16000, 16000), (16000, 8000), (48000, 16000)])
def test_resample_matches_jax(rates):
    x = np.random.default_rng(4).standard_normal(4800).astype(np.float32)
    got = native.resample_linear(x, *rates)
    assert len(got) == round(len(x) * rates[1] / rates[0])
    np.testing.assert_allclose(got, jnative.resample_linear(x, *rates), atol=1e-6)


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """``native`` as if not loaded yet, building under ``tmp_path``."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    monkeypatch.setattr(cuda_build, "_build_root", str(tmp_path / "build"))
    monkeypatch.setattr(compile_cache, "_enabled", None)
    return tmp_path


def test_a_failed_build_says_so_once_and_the_numpy_path_runs(fresh_native, monkeypatch, capsys):
    monkeypatch.setenv("CXX", str(fresh_native / "no-such-compiler"))
    assert not native.have_native()
    err = capsys.readouterr().err
    assert "host ops build failed" in err and "numpy host ops" in err
    assert native.levenshtein("kitten", "sitting") == 3
    np.testing.assert_allclose(native.resample_linear(np.arange(6, dtype=np.float32), 2, 1),
                               [0, 2, 4])
    assert not native.have_native()
    assert capsys.readouterr().err == ""


def test_compile_cache_dir_moves_the_builds(fresh_native, monkeypatch):
    assert compile_cache.enable_compile_cache("") is None
    monkeypatch.setenv("HOME", str(fresh_native))
    path = compile_cache.enable_compile_cache("~/cache")
    assert path == str(fresh_native / "cache") and os.path.isdir(path)
    assert compile_cache.enable_compile_cache("~/cache") == path
    assert cuda_build.build_dir() == os.path.join(path, "kernels")
    assert cuda_build.library_path("logmel").startswith(os.path.join(path, "kernels", "liblogmel-"))
    assert native.have_native()
    assert native.library_path().startswith(os.path.join(path, "hostops", "libhostops-"))
    assert os.path.isfile(native.library_path())
    # A second process (here: a reset module) finds the library and builds nothing.
    monkeypatch.setattr(native, "_lib", None)
    before = os.path.getmtime(native.library_path())
    assert native.have_native() and os.path.getmtime(native.library_path()) == before


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 3)

    def forward(self, x):
        return torch.log(self.fc(x))


def test_trace_writes_the_annotated_ranges(tmp_path):
    model = _Tiny()
    with profiling.trace(str(tmp_path / "prof"), device="cpu") as prof:
        with profiling.annotate("tiny_block"):
            model(torch.ones(2, 4))
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert '"tiny_block"' in f.read()
    assert any(e.key == "tiny_block" for e in prof.key_averages())


def test_nan_guard_traps_the_first_non_finite_forward_and_backward():
    model = _Tiny()
    with torch.no_grad():
        model.fc.weight.fill_(-1.0)
        model.fc.bias.zero_()
    before = torch.is_anomaly_enabled()
    with pytest.raises(FloatingPointError, match="Linear|_Tiny"):
        with profiling.nan_guard():
            model(torch.ones(2, 4))
    assert torch.is_anomaly_enabled() == before
    assert torch.isnan(model(torch.ones(2, 4))).all()      # guard gone: NaN flows again
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with profiling.nan_guard():
            torch.where(x > 0, torch.sqrt(x), 0.0).sum().backward()
    assert torch.is_anomaly_enabled() == before


def test_device_memory_stats_without_a_card():
    assert profiling.device_memory_stats() == {"cpu": None}


def test_decode_ctc_and_encode_array_match_jax():
    pt, jt = ptokenizer.CharTokenizer(VOCAB), jtokenizer.CharTokenizer(VOCAB)
    ids = [3, 40, 3, 40, 4, 41, 900, 3, 5]
    assert pt.decode_ctc(ids) == jt.decode_ctc(ids)
    for text, pad in [("안녕 하세요", None), ("안녕 하세요", 3), ("안녕", 8), ("", 4)]:
        got, want = pt.encode_array(text, pad), jt.encode_array(text, pad)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_vocab_files_are_jax_s_byte_for_byte(tmp_path):
    rng = np.random.default_rng(7)
    chars = list("가나다라마바사아자차카타파하 abc")
    folder = tmp_path / "txt"
    folder.mkdir()
    for i in range(6):
        text = "".join(chars[j] for j in rng.integers(0, len(chars), size=200))
        (folder / f"{i:02d}.txt").write_text(text, encoding="utf-8")
    (folder / "skip.md").write_text("zzz", encoding="utf-8")
    for size in (800, 10):
        p, j = tmp_path / f"port{size}.vocab", tmp_path / f"jax{size}.vocab"
        tok = ptokenizer.train_tokenizer_from_txt_folder(str(folder), str(p), size)
        jtokenizer.train_tokenizer_from_txt_folder(str(folder), str(j), size)
        assert p.read_bytes() == j.read_bytes()
        assert tok.vocab_size == min(size, 4 + len(set(chars)))
    texts = ["가 나", "나나", ""]
    assert ptokenizer.build_char_vocab(texts) == jtokenizer.build_char_vocab(texts)
