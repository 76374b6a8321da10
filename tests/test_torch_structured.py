"""PyTorch port, the research data sources and tools: ``data/structured.py``
(``StructuredPairSource`` with and without its Markov chain,
``RealTextStructuredSource``, ``load_reference_sentences``),
``train/probe.py`` and ``data/validate.py``, held against the JAX package's
modules on the same seeds and files.  Pairs are compared byte for byte,
probe accuracies and reports exactly.  Nothing reads a corpus the test does
not write."""

import json
import os

import numpy as np
import pytest
import torch

from multimodal_av_model_tpu.data import structured as jstructured
from multimodal_av_model_tpu.data import validate as jvalidate
from multimodal_av_model_tpu.data.manifest import SentenceEntry as JEntry
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu.train import probe as jprobe
from multimodal_av_model_tpu_torch.data import structured, validate
from multimodal_av_model_tpu_torch.data.audio_io import write_wav
from multimodal_av_model_tpu_torch.data.manifest import SentenceEntry
from multimodal_av_model_tpu_torch.text import CharTokenizer
from multimodal_av_model_tpu_torch.train import probe

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
SENTENCES = ["안녕하세요 오늘 날씨가 좋네요", "네 반갑습니다", "",
             "이 문장은 열두 글자보다 훨씬 더 깁니다 그래서 잘립니다", "가"]


def _assert_pairs_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("markov", [False, True])
def test_structured_pairs_equal_jax(seed, markov):
    kw = dict(seed=seed, markov=markov, lip_size=24, label_len=(2, 6))
    ours = structured.StructuredPairSource(CharTokenizer(VOCAB), **kw)
    theirs = jstructured.StructuredPairSource(JTokenizer(VOCAB), **kw)
    if markov:
        np.testing.assert_array_equal(ours.transition, theirs.transition)
    for _ in range(4):
        _assert_pairs_equal(ours.load_pair(), theirs.load_pair())


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("min_chars", [None, 2])
def test_real_text_pairs_equal_jax(seed, min_chars):
    sents = [s for s in SENTENCES if s]
    kw = dict(seed=seed, max_chars=6, min_chars=min_chars, lip_size=16, frames_per_token=2)
    ours = structured.RealTextStructuredSource(CharTokenizer(VOCAB), sents, **kw)
    theirs = jstructured.RealTextStructuredSource(JTokenizer(VOCAB), sents, **kw)
    for _ in range(5):
        _assert_pairs_equal(ours.load_pair(), theirs.load_pair())


def test_real_text_source_refusals():
    with pytest.raises(ValueError, match="at least one sentence"):
        structured.RealTextStructuredSource(CharTokenizer(VOCAB), [])
    with pytest.raises(ValueError, match="chords"):
        structured.RealTextStructuredSource(CharTokenizer(VOCAB), ["가"], n_base=10)


def test_load_reference_sentences_equals_jax(tmp_path):
    """A dict document, a one-element list document, an empty list and a
    document without ``Sentence_info``; blank texts are dropped."""
    docs = {
        "b.json": {"Sentence_info": [{"sentence_text": " 첫 문장 "}, {"sentence_text": ""},
                                     {"sentence_text": "둘째"}, {}]},
        "a.json": [{"Sentence_info": [{"sentence_text": "셋째 문장"}]}],
        "c.json": [],
        "d.json": {"other": 1},
    }
    for name, doc in docs.items():
        with open(tmp_path / name, "w", encoding="utf-8") as f:
            json.dump(doc, f, ensure_ascii=False)
    got = structured.load_reference_sentences(str(tmp_path))
    assert got == jstructured.load_reference_sentences(str(tmp_path))
    assert got == ["셋째 문장", "첫 문장", "둘째"]


def _outputs(seed, n=3, B=2, T=20, P=8):
    """Model-output dicts: torch tensors for the port, arrays for JAX."""
    rng = np.random.default_rng(seed)
    outs = []
    for _ in range(n):
        d = {}
        for s in ("1", "2"):
            mask = rng.integers(0, 4, size=(B, T)).astype(np.int32)
            feat = rng.standard_normal((B, T, P)).astype(np.float32)
            feat[..., 0] += np.where(mask == 1, 4.0, -4.0)    # separable classes
            d["contrast" + s], d["mask_ds" + s] = feat, mask
        outs.append(d)
    return outs


@pytest.mark.parametrize("speaker", [1, 2])
def test_probe_equals_jax(speaker):
    outs = _outputs(speaker)
    as_torch = [{k: torch.from_numpy(v) for k, v in d.items()} for d in outs]
    feats, labels = probe.collect_frame_features(as_torch, speaker)
    j_feats, j_labels = jprobe.collect_frame_features(outs, speaker)
    np.testing.assert_array_equal(feats, j_feats)
    np.testing.assert_array_equal(labels, j_labels)
    assert 3 not in labels
    y = probe.overlap_vs_solo_labels(labels)
    np.testing.assert_array_equal(y, jprobe.overlap_vs_solo_labels(j_labels))
    for seed in (0, 1):
        acc = probe.nearest_centroid_probe(feats, y, seed=seed)
        assert acc == jprobe.nearest_centroid_probe(j_feats, y, seed=seed)
        assert acc > 0.9
    bf16 = [{k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in d.items()}
            for d in as_torch]
    assert probe.collect_frame_features(bf16, speaker)[0].dtype == np.float32


def _corpus(tmp_path):
    """Entries over files on disk: good ones, and one each missing text, lip
    and audio, an empty, a 2-D and an unreadable lip array, reversed and
    zero-length times and one too long."""
    rng = np.random.default_rng(0)
    rows = []

    def entry(name, lip="ok", text=True, audio=True, start=0.0, end=1.5):
        lip_path = str(tmp_path / f"{name}.npy")
        if lip == "ok":
            np.save(lip_path, rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8))
        elif lip == "empty":
            np.save(lip_path, np.zeros((0, 8, 8, 3), np.uint8))
        elif lip == "2d":
            np.save(lip_path, np.zeros((8, 8), np.uint8))
        elif lip == "corrupt":
            with open(lip_path, "wb") as f:
                f.write(b"not an npy file")
        text_path = str(tmp_path / f"{name}.txt")
        if text:
            with open(text_path, "w", encoding="utf-8") as f:
                f.write("안녕")
        audio_path = str(tmp_path / f"{name}.wav")
        if audio:
            write_wav(audio_path, np.zeros(1600, np.float32), 16000)
        rows.append((lip_path, text_path, audio_path, start, end, "안녕", len(rows), name))

    entry("good0")
    entry("no_text", text=False)
    entry("no_lip", lip=None)
    entry("no_audio", audio=False)
    entry("empty", lip="empty")
    entry("flat", lip="2d")
    entry("corrupt", lip="corrupt")
    entry("reversed", start=2.0, end=1.0)
    entry("zero", start=1.0, end=1.0)
    entry("long", end=31.0)
    entry("good1", start=0.25, end=3.75)
    return rows


@pytest.mark.parametrize("check_lip_contents", [False, True])
def test_validate_manifest_equals_jax(tmp_path, check_lip_contents):
    rows = _corpus(tmp_path)
    ours = validate.validate_manifest([SentenceEntry(*r) for r in rows], check_lip_contents)
    theirs = jvalidate.validate_manifest([JEntry(*r) for r in rows], check_lip_contents)
    assert [e.base_name for e in ours.ok] == [e.base_name for e in theirs.ok]
    assert [(e.base_name, r) for e, r in ours.skipped] == \
        [(e.base_name, r) for e, r in theirs.skipped]
    assert ours.summary() == theirs.summary()
    kinds = {e.base_name: r.split(":")[0] for e, r in ours.skipped}
    want = {"no_text": "missing_text", "no_lip": "missing_lip", "no_audio": "missing_audio",
            "reversed": "bad_times", "zero": "bad_times", "long": "too_long"}
    if check_lip_contents:
        want.update(empty="bad_lip_shape", flat="bad_lip_shape", corrupt="unreadable_lip")
    assert kinds == want
    assert {e.base_name for e in ours.ok} == {r[7] for r in rows} - set(want)
