"""PyTorch port, the host data pipeline of the training run: each module of
``multimodal_av_model_tpu_torch/data`` against its counterpart in the JAX
package, on the same seeds and the same files on disk.

Tolerances: everything is equal (bit-equal arrays, equal sequences, equal
files byte for byte) except ``FilePairSource.load_pair``'s lips, within
1e-6 absolute (the JAX package may resize with its native host op).
"""

import dataclasses
import os
import struct
import threading
import time

import numpy as np
import pytest
import torch

from multimodal_av_model_tpu.data import audio_io as j_audio
from multimodal_av_model_tpu.data import collate as j_collate
from multimodal_av_model_tpu.data import manifest as j_manifest
from multimodal_av_model_tpu.data import pairs as j_pairs
from multimodal_av_model_tpu.data import pipeline as j_pipeline
from multimodal_av_model_tpu.data.synth_corpus import write_synthetic_corpus as j_write_corpus
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu_torch.data import audio_io, collate, manifest, pairs, pipeline
from multimodal_av_model_tpu_torch.data.synth_corpus import write_synthetic_corpus
from multimodal_av_model_tpu_torch.text import CharTokenizer

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")


@pytest.fixture(scope="module")
def toks():
    return JTokenizer(VOCAB), CharTokenizer(VOCAB)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, toks):
    """A small corpus written by the JAX package: 4 speakers x 5 sentences."""
    root = str(tmp_path_factory.mktemp("corpus"))
    return j_write_corpus(root, toks[0], n_videos=4, sentences_per_video=5,
                          sentence_dur=0.3, gap=0.1, seed=3)


def _entries(dirs, mod):
    return mod.build_data_list(dirs["json_folder"], dirs["npy_dir"], dirs["text_dir"],
                               dirs["wav_dir"])


def _assert_same(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), \
        (type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# -- audio_io -------------------------------------------------------------------

def _write_float32_wav(path, audio, sr):
    data = np.asarray(audio, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, sr, sr * 4, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)) + data)


@pytest.mark.parametrize("kind", ["pcm16_mono", "pcm16_stereo", "float32_riff"])
def test_read_and_write_wav_match_jax(tmp_path, kind):
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((4800, 2) if kind == "pcm16_stereo" else 4800) * 0.3
             ).astype(np.float32)
    ours, theirs = str(tmp_path / "ours.wav"), str(tmp_path / "theirs.wav")
    if kind == "float32_riff":
        _write_float32_wav(theirs, audio, 48000)
    else:
        audio_io.write_wav(ours, audio, 48000)
        j_audio.write_wav(theirs, audio, 48000)
        with open(ours, "rb") as f, open(theirs, "rb") as g:
            assert f.read() == g.read()
    got, sr = audio_io.read_wav(theirs)
    want, want_sr = j_audio.read_wav(theirs)
    assert sr == want_sr == 48000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if kind == "float32_riff":
        np.testing.assert_array_equal(got, audio)


def test_resample_and_wav_cache_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(48000).astype(np.float32) * 0.2
    np.testing.assert_array_equal(audio_io.resample(x, 48000, 16000),
                                  j_audio.resample(x, 48000, 16000))
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"w{i}.wav"))
        j_audio.write_wav(paths[-1], rng.standard_normal(24000) * 0.1, 48000)
    ours = audio_io.WavCache(target_sr=16000, max_items=2)
    theirs = j_audio.WavCache(target_sr=16000, max_items=2)
    for p, t0, t1 in ((paths[0], 0.1, 0.35), (paths[1], 0.0, 0.5), (paths[0], 0.2, 0.21),
                      (paths[2], 0.05, 0.45), (paths[1], 0.3, 0.5)):
        np.testing.assert_array_equal(ours.load_segment(p, t0, t1),
                                      theirs.load_segment(p, t0, t1))
        assert list(ours._cache) == list(theirs._cache)
    assert len(ours._cache) == 2


# -- manifest and pairs -----------------------------------------------------------

def test_manifest_and_split_match_jax(corpus, tmp_path):
    dirs = dict(corpus)
    # A text dir missing one file puts that sentence on the skip list.
    dirs["text_dir"] = str(tmp_path / "text")
    os.makedirs(dirs["text_dir"])
    for name in sorted(os.listdir(corpus["text_dir"]))[1:]:
        with open(os.path.join(corpus["text_dir"], name), "rb") as f, \
                open(os.path.join(dirs["text_dir"], name), "wb") as g:
            g.write(f.read())
    got, got_skip = _entries(dirs, manifest)
    want, want_skip = _entries(dirs, j_manifest)
    assert got_skip == want_skip and len(got_skip) == 1
    assert [dataclasses.asdict(e) for e in got] == [dataclasses.asdict(e) for e in want]
    assert got[0]["lip_path"] == got[0].lip_path and got[0].duration == want[0].duration
    for seed in (0, 42):
        for a, b in zip(manifest.train_val_test_split(got, seed=seed),
                        j_manifest.train_val_test_split(want, seed=seed)):
            assert [e.lip_path for e in a] == [e.lip_path for e in b]
    assert manifest.speaker_id_of(got[0].text_path) == j_manifest.speaker_id_of(want[0].text_path)
    out = [str(tmp_path / "labels_ours"), str(tmp_path / "labels_theirs")]
    js = os.path.join(corpus["json_folder"], sorted(os.listdir(corpus["json_folder"]))[0])
    assert manifest.save_sentence_labels(js, out[0]) == j_manifest.save_sentence_labels(js, out[1])
    assert sorted(os.listdir(out[0])) == sorted(os.listdir(out[1]))


def _recording_load(fail_every=0):
    """A load_fn that records each call and fails on every ``fail_every``-th."""
    calls = []

    def load(s1, s2):
        calls.append((s1["lip_path"], s2["lip_path"]))
        if fail_every and len(calls) % fail_every == 0:
            raise OSError("unreadable")
        return calls[-1]
    return load, calls


@pytest.mark.parametrize("fail_every", [0, 3])
def test_pair_samplers_match_jax(corpus, fail_every):
    ours, _ = _entries(corpus, manifest)
    theirs, _ = _entries(corpus, j_manifest)
    fixed = pairs.generate_fixed_pairs(ours, 12, seed=5)
    j_fixed = j_pairs.generate_fixed_pairs(theirs, 12, seed=5)
    assert [(a.lip_path, b.lip_path) for a, b in fixed] == \
        [(a.lip_path, b.lip_path) for a, b in j_fixed]
    # A pair list with single-speaker pairs, which the fixed sampler skips.
    same = [(ours[0], ours[1]), (ours[0], ours[7]), (ours[2], ours[3]), (ours[5], ours[9])]
    j_same = [(theirs[0], theirs[1]), (theirs[0], theirs[7]), (theirs[2], theirs[3]),
              (theirs[5], theirs[9])]
    for make, args in ((lambda m, e, f: m.RandomPairSampler(e, f, 10, seed=7), None),
                       (lambda m, e, f: m.FixedPairSampler(e, f), "fixed"),
                       (lambda m, e, f: m.FixedPairSampler(e, f), "same")):
        lo, calls = _recording_load(fail_every)
        jlo, j_calls = _recording_load(fail_every)
        src = {None: (ours, theirs), "fixed": (fixed, j_fixed), "same": (same, j_same)}[args]
        got = list(make(pairs, src[0], lo))
        want = list(make(j_pairs, src[1], jlo))
        assert got == want and calls == j_calls and len(got) == (10 if args is None
                                                                 else len(src[0]))
    with pytest.raises(ValueError):
        pairs.RandomPairSampler(ours[:1], lambda a, b: None)
    with pytest.raises(RuntimeError, match="exhausted"):
        pairs.RandomPairSampler(ours, _recording_load(1)[0], 1).sample()


# -- collation and bucketing -----------------------------------------------------

@pytest.fixture(scope="module")
def sources(toks):
    return (pipeline.SyntheticPairSource(toks[1], seed=4, video_frames=(3, 12), lip_size=8,
                                         label_len=(2, 9)),
            j_pipeline.SyntheticPairSource(toks[0], seed=4, video_frames=(3, 12), lip_size=8,
                                           label_len=(2, 9)))


def test_synthetic_pair_source_matches_jax(sources):
    ours, theirs = sources
    for _ in range(6):
        _assert_same(ours.load_pair(), theirs.load_pair())


def test_pick_bucket_and_collate_pairs_match_jax(toks):
    specs = collate.make_bucket_specs((4, 8, 12), 534, 6)
    j_specs = j_collate.make_bucket_specs((4, 8, 12), 534, 6)
    for v, a in ((1, 10), (4, 2136), (4, 2137), (9, 100), (12, 6408), (40, 99999)):
        assert dataclasses.astuple(collate.pick_bucket(specs, v, a)) == \
            dataclasses.astuple(j_collate.pick_bucket(j_specs, v, a))
    src = j_pipeline.SyntheticPairSource(toks[0], seed=2, video_frames=(3, 14), lip_size=8,
                                         label_len=(2, 9))
    samples = [src.load_pair() for _ in range(3)]
    spec = specs[1]
    _assert_same(collate.collate_pairs(samples, spec),
                 j_collate.collate_pairs(samples, j_specs[1]))


def _raw_samples(rng, n):
    out = []
    for _ in range(n):
        s = {}
        for k in ("1", "2"):
            T = int(rng.integers(2, 14))
            s[f"lip{k}_raw"] = rng.integers(0, 256, (T, 6, 6, 3), dtype=np.uint8)
            s[f"lip{k}_len"] = T
            s[f"audio{k}"] = rng.standard_normal(int(rng.integers(100, 6000))).astype(np.float32)
            s[f"label{k}"] = rng.integers(5, 800, int(rng.integers(1, 9)))
        out.append(s)
    return out


@pytest.mark.parametrize("layout", ["raw", "processed"])
def test_bucketed_batches_match_jax(toks, layout):
    """Flush batches included: their padding rows have ``valid`` 0, and
    ``num_real`` counts the real ones."""
    specs = collate.make_bucket_specs((4, 8, 12), 534, 6)
    j_specs = j_collate.make_bucket_specs((4, 8, 12), 534, 6)
    if layout == "raw":
        samples = _raw_samples(np.random.default_rng(6), 11)
        fns = (collate.collate_pairs_raw, j_collate.collate_pairs_raw)
    else:
        src = j_pipeline.SyntheticPairSource(toks[0], seed=8, video_frames=(2, 14), lip_size=8)
        samples = [src.load_pair() for _ in range(11)]
        fns = (collate.collate_pairs, j_collate.collate_pairs)
    got = list(pipeline.bucketed_batches(iter(samples), specs, 3, collate_fn=fns[0]))
    want = list(j_pipeline.bucketed_batches(iter(samples), j_specs, 3, collate_fn=fns[1]))
    assert len(got) == len(want) and any("num_real" in b for b in got)
    for a, b in zip(got, want):
        _assert_same(a, b)
    flush = [b for b in got if "num_real" in b]
    assert all(b["valid"][int(b["num_real"]):].sum() == 0 for b in flush)
    dropped = list(pipeline.bucketed_batches(iter(samples), specs, 3, drop_last=True,
                                             collate_fn=fns[0]))
    assert len(dropped) == len(got) - len(flush)


# -- file pair source --------------------------------------------------------------

def test_file_pair_source_matches_jax(corpus, toks):
    ours, _ = _entries(corpus, manifest)
    theirs, _ = _entries(corpus, j_manifest)
    src = pipeline.FilePairSource(toks[1], 16000)
    j_src = j_pipeline.FilePairSource(toks[0], 16000)
    for i, j in ((0, 6), (11, 3), (19, 8)):
        _assert_same(src.load_pair_raw(ours[i], ours[j]),
                     j_src.load_pair_raw(theirs[i], theirs[j]))
        got, want = src.load_pair(ours[i], ours[j]), j_src.load_pair(theirs[i], theirs[j])
        for k in ("lip1", "lip2"):
            assert got[k].shape == want[k].shape and got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
            got[k] = want[k]
        _assert_same(got, want)
    # The text file is read when the manifest carries no sentence text.
    bare = dataclasses.replace(ours[0], sentence_text="")
    np.testing.assert_array_equal(src._label(bare), src._label(ours[0]))


# -- the corpus writer ------------------------------------------------------------

def _tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_write_synthetic_corpus_is_byte_identical(tmp_path, toks):
    kw = dict(n_videos=2, sentences_per_video=3, sentence_dur=0.2, gap=0.1, seed=9)
    got = write_synthetic_corpus(str(tmp_path / "ours"), toks[1], **kw)
    want = j_write_corpus(str(tmp_path / "theirs"), toks[0], **kw)
    assert {k: os.path.relpath(v, tmp_path / "ours") for k, v in got.items()} == \
        {k: os.path.relpath(v, tmp_path / "theirs") for k, v in want.items()}
    a, b = _tree(tmp_path / "ours"), _tree(tmp_path / "theirs")
    assert sorted(a) == sorted(b) and len(a) == 2 * (2 + 2 * 3)
    for name in a:
        assert a[name] == b[name], name


def test_write_synthetic_corpus_with_a_duration_range(tmp_path, toks):
    """Per-sentence durations in the range, in the same layout the manifest reads."""
    dirs = write_synthetic_corpus(str(tmp_path), toks[1], n_videos=2, sentences_per_video=4,
                                  sentence_dur=(0.2, 0.5), seed=1)
    entries, skipped = _entries(dirs, manifest)
    assert not skipped and len(entries) == 8
    durs = [e.duration for e in entries]
    assert all(0.199 <= d <= 0.501 for d in durs) and len(set(durs)) == len(durs)
    for e in entries:
        assert abs(np.load(e.lip_path).shape[0] - e.duration * 30) <= 1
        assert e.end_time <= audio_io.read_wav(e.audio_path)[0].shape[0] / 48000


# -- prefetching loader -------------------------------------------------------------

def test_prefetching_loader_order_errors_and_reiteration():
    def factory():
        return iter([{"i": np.int32(k)} for k in range(20)])
    for mod in (pipeline, j_pipeline):
        loader = mod.PrefetchingLoader(factory, depth=3)
        assert [int(b["i"]) for b in loader] == list(range(20))
        assert len(list(loader)) == 20               # the factory runs again

    def bad():
        yield {"i": np.int32(0)}
        raise RuntimeError("boom in worker")
    with pytest.raises(RuntimeError, match="boom in worker"):
        list(pipeline.PrefetchingLoader(bad, depth=2))


def test_prefetching_loader_places_on_device_and_stops_with_its_consumer():
    batches = [{"x": np.arange(6, dtype=np.float32).reshape(2, 3) + k, "num_real": np.int32(2)}
               for k in range(50)]
    placed = pipeline.PrefetchingLoader(lambda: iter(batches), depth=2, device="cpu")
    got = list(placed)
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu" for b in got)
    assert isinstance(got[0]["num_real"], np.int32)
    torch.testing.assert_close(got[7]["x"], torch.from_numpy(batches[7]["x"]))

    before = {t.ident for t in threading.enumerate()}
    it = iter(pipeline.PrefetchingLoader(lambda: iter(batches), depth=2))
    next(it)
    it.close()                                       # the consumer stops reading
    deadline = time.time() + 5
    while time.time() < deadline and any(
            t.name == "prefetch" and t.ident not in before for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "prefetch" and t.ident not in before
                   for t in threading.enumerate())
