"""PyTorch port, the raw-media corpus path (JAX's ``tests/test_avi.py:98``):
``write_raw_media_corpus`` -> ``extract_clips`` from the precomputed boxes ->
``save_all_sentence_labels`` -> ``build_data_list`` ->
``FilePairSource.load_pair_raw`` -> ``collate_pairs_raw`` ->
``device_preprocessed_batches`` (on the CPU: K2's plain version) -> one tiny
f32 ``train_step``.

Held against the JAX package on the same seed: every file the writer
writes, the extracted crops and the labels byte-equal; the collated batch
against JAX's ``FilePairSource.load_pair`` + ``collate_pairs`` on the same
entries (masks, texts and lengths exact; the mixture within 1e-6; the lips,
resized on the host by JAX and by K2's plain version here, within 1e-5).
"""

import os

import numpy as np
import pytest
import torch

from multimodal_av_model_tpu.data.avi import avi_frame_reader as j_avi_reader
from multimodal_av_model_tpu.data.collate import BucketSpec as JBucketSpec
from multimodal_av_model_tpu.data.collate import collate_pairs as j_collate_pairs
from multimodal_av_model_tpu.data.lip_extract import extract_clips as j_extract_clips
from multimodal_av_model_tpu.data.manifest import build_data_list as j_build_data_list
from multimodal_av_model_tpu.data.manifest import (
    save_all_sentence_labels as j_save_all_sentence_labels,
)
from multimodal_av_model_tpu.data.pipeline import FilePairSource as JFilePairSource
from multimodal_av_model_tpu.data.synth_corpus import (
    write_raw_media_corpus as j_write_raw_media_corpus,
)
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu_torch.data.avi import avi_frame_reader
from multimodal_av_model_tpu_torch.data.collate import BucketSpec, collate_pairs_raw
from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches
from multimodal_av_model_tpu_torch.data.lip_extract import extract_clips
from multimodal_av_model_tpu_torch.data.manifest import build_data_list, save_all_sentence_labels
from multimodal_av_model_tpu_torch.data.pipeline import FilePairSource
from multimodal_av_model_tpu_torch.data.synth_corpus import write_raw_media_corpus
from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
from multimodal_av_model_tpu_torch.text import CharTokenizer
from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer
from test_models import tiny_config
from test_torch_models import port_config

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
LIP = 32
SPEC = (LIP, LIP * 534, 16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _extract(dirs, extract, reader):
    """Each video's sentences cropped at 64x64 from its precomputed boxes."""
    saved = []
    for name in sorted(os.listdir(dirs["json_folder"])):
        base = name[:-len(".json")]
        boxes = np.load(os.path.join(dirs["boxes_dir"], base + "_boxes.npy"))
        res = extract(reader(os.path.join(dirs["video_dir"], base + ".avi")),
                      os.path.join(dirs["json_folder"], name), dirs["npy_dir"], base,
                      fps=30, out_size=64, boxes_for_range=lambda s, e, b=boxes: b[s:e])
        assert len(res.saved) == 3 and not res.skipped
        saved += res.saved
    return saved


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Both packages' corpora (JAX's defaults: 2 videos x 3 sentences, seed
    0), before and after extraction and labelling."""
    root = tmp_path_factory.mktemp("raw_media")
    out = {}
    for side, write, tok in (("jax", j_write_raw_media_corpus, JTokenizer(VOCAB)),
                             ("port", write_raw_media_corpus, CharTokenizer(VOCAB))):
        dirs = write(str(root / side), tok)
        written = _files(str(root / side))
        out[side] = {"dirs": dirs, "written": written}
    out["jax"]["saved"] = _extract(out["jax"]["dirs"], j_extract_clips, j_avi_reader)
    out["port"]["saved"] = _extract(out["port"]["dirs"], extract_clips, avi_frame_reader)
    out["jax"]["labels"] = j_save_all_sentence_labels(out["jax"]["dirs"]["json_folder"],
                                                      out["jax"]["dirs"]["text_dir"])
    out["port"]["labels"] = save_all_sentence_labels(out["port"]["dirs"]["json_folder"],
                                                     out["port"]["dirs"]["text_dir"])
    out["root"] = root
    return out


def _bytes(root, rel):
    with open(os.path.join(root, rel), "rb") as f:
        return f.read()


def test_write_raw_media_corpus_is_byte_equal(corpora):
    root = corpora["root"]
    written = corpora["port"]["written"]
    assert written == corpora["jax"]["written"]
    kinds = {os.path.splitext(f)[1] for f in written}
    assert kinds == {".avi", ".npy", ".wav", ".json"}, kinds
    for rel in written:
        assert _bytes(root / "port", rel) == _bytes(root / "jax", rel), rel
    assert set(corpora["port"]["dirs"]) == set(corpora["jax"]["dirs"])


def test_extracted_crops_are_byte_equal(corpora):
    root = corpora["root"]
    crops = [os.path.relpath(p, root / "port") for p in corpora["port"]["saved"]]
    assert crops == [os.path.relpath(p, root / "jax") for p in corpora["jax"]["saved"]]
    for rel in crops:
        assert _bytes(root / "port", rel) == _bytes(root / "jax", rel), rel


def test_save_all_sentence_labels_count_and_contents(corpora):
    assert corpora["port"]["labels"] == corpora["jax"]["labels"] == 6
    root = corpora["root"]
    text = corpora["port"]["dirs"]["text_dir"]
    names = sorted(os.listdir(text))
    assert names == sorted(os.listdir(corpora["jax"]["dirs"]["text_dir"])) and len(names) == 6
    for name in names:
        rel = os.path.relpath(os.path.join(text, name), root / "port")
        assert _bytes(root / "port", rel) == _bytes(root / "jax", rel), name


@pytest.fixture(scope="module")
def batches(corpora):
    """The speaker-distinct pair (sentence 1 of video 1, sentence 1 of video
    2) twice: the port's raw path on the CPU, and JAX's host path."""
    pd, jd = corpora["port"]["dirs"], corpora["jax"]["dirs"]
    entries, skipped = build_data_list(pd["json_folder"], pd["npy_dir"], pd["text_dir"],
                                       pd["wav_dir"])
    j_entries, j_skipped = j_build_data_list(jd["json_folder"], jd["npy_dir"], jd["text_dir"],
                                             jd["wav_dir"])
    assert len(entries) == len(j_entries) == 6 and not skipped and not j_skipped
    tok = CharTokenizer(VOCAB)
    raw = FilePairSource(tok, 16000).load_pair_raw(entries[0], entries[3])
    assert raw["lip1_raw"].dtype == np.uint8 and raw["lip1_raw"].shape[1:] == (64, 64, 3)
    raw_batch = collate_pairs_raw([raw, raw], BucketSpec(*SPEC))
    (port,) = device_preprocessed_batches([raw_batch], out_size=LIP, device="cpu")
    pair = JFilePairSource(JTokenizer(VOCAB), 16000, lip_size=LIP).load_pair(j_entries[0],
                                                                             j_entries[3])
    jax_batch = j_collate_pairs([pair, pair], JBucketSpec(*SPEC))
    return port, jax_batch


def test_collated_batch_matches_jax_s(batches):
    port, want = batches
    for k in ("mask1", "mask2", "lip1_lengths", "lip2_lengths", "text1", "text1_lengths",
              "text2", "text2_lengths"):
        np.testing.assert_array_equal(np.asarray(port[k]), want[k], err_msg=k)
    np.testing.assert_allclose(port["audio"].numpy(), want["audio"], rtol=0, atol=1e-6)
    for k in ("lip1", "lip2"):
        assert port[k].shape == want[k].shape == (2, LIP, 1, LIP, LIP)
        np.testing.assert_allclose(port[k].numpy(), want[k], rtol=0, atol=1e-5, err_msg=k)


def test_one_train_step_on_the_raw_media_batch(batches):
    port, _ = batches
    cfg = tiny_config()
    cfg.model.decoder.vocab_size = 800
    cfg.model.dtype = "float32"
    cfg = port_config(cfg)
    trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model), CharTokenizer(VOCAB),
                                  device="cpu")
    state, metrics = trainer.train_step(trainer.init_state(0), port)
    assert np.isfinite(metrics["loss"].item()) and metrics["loss"].item() > 0
    assert state.step == 1
