"""PyTorch port, the serving export: K1 and K2 as operators
(``mmav::log_mel``, ``mmav::lip_preprocess``), ``export_transcriber`` and
``ExportedTranscriber``, in the tiny configuration of the JAX package's own
export test (``tests/test_infer.py:127-176``: f32, the transformer temporal
model, bucket 8, B = 2), with the JAX weights carried over by
``compat/from_jax.py``.

Held exactly: the artifact's ids against the port's ``Transcriber`` on the
same batch, its texts against the JAX ``ExportedTranscriber``'s, and
``meta.json`` against JAX's; for the prefix beam with a fusion LM, greedy,
and int8 greedy.  The operators pass ``torch.library.opcheck`` on the CPU."""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu.data import SyntheticPairSource
from multimodal_av_model_tpu.data import collate_pairs as j_collate_pairs
from multimodal_av_model_tpu.data.collate import BucketSpec
from multimodal_av_model_tpu.infer import ExportedTranscriber as JExported
from multimodal_av_model_tpu.infer import Transcriber as JTranscriber
from multimodal_av_model_tpu.infer import export_transcriber as j_export
from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu.text.ngram_lm import save_bigram_lm, train_bigram_lm
from multimodal_av_model_tpu_torch.compat import from_jax_variables
from multimodal_av_model_tpu_torch.infer import (
    ExportedTranscriber,
    Transcriber,
    decode_ids,
    export_transcriber,
)
from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
from multimodal_av_model_tpu_torch.ops import logmel, resize
from multimodal_av_model_tpu_torch.text import CharTokenizer
from test_models import tiny_config
from test_torch_models import perturb_batch_stats, port_config

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
KEYS = ("lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models run many small ops, which torch's thread pool slows when
    the suite's workers already share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """JAX's export-test configuration, weights (non-trivial BatchNorm
    statistics) and batch."""
    jtok = JTokenizer(VOCAB)
    cfg = tiny_config()
    cfg.model.decoder.vocab_size = jtok.vocab_size
    cfg.model.fusion.temporal_model = "transformer"
    cfg.decode.algorithm = "prefix_beam"
    src = SyntheticPairSource(jtok, seed=0, video_frames=(4, 7), lip_size=24, label_len=(2, 5))
    batch = j_collate_pairs([src.load_pair() for _ in range(2)], BucketSpec(8, 4272, 8))
    batch = {k: batch[k] for k in KEYS}
    v = perturb_batch_stats(jax.jit(JModel(cfg.model).init)(
        jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in KEYS)))
    return cfg, v, batch


def _port_transcriber(cfg, v, quantize=False):
    model = MultiSpeakerAVModel(port_config(cfg).model)
    model.load_state_dict(from_jax_variables(v), strict=True)
    return Transcriber(port_config(cfg), CharTokenizer(VOCAB), model, device="cpu",
                       quantize=quantize, quantize_min_size=256)


def _ids(t: Transcriber, batch, use_beam):
    """The Transcriber's decoded ids and lengths, both speakers as one [2B] batch."""
    with torch.no_grad():
        out = t.forward(*(torch.from_numpy(np.asarray(batch[k])) for k in KEYS))
        return decode_ids(t.config, torch.cat([out["log_probs1"], out["log_probs2"]]),
                          torch.cat([out["input_lengths1"], out["input_lengths2"]]),
                          use_beam, t.lm)


def _check_artifact(t, out_dir, jax_dir, batch, use_beam):
    """The port's artifact in ``out_dir`` against ``t`` and JAX's in ``jax_dir``."""
    served = ExportedTranscriber.load(out_dir, device="cpu")
    with torch.no_grad():
        ids1, len1, ids2, len2 = served.module(
            served.lm, *(torch.from_numpy(np.asarray(batch[k])) for k in KEYS))
    want_ids, want_len = _ids(t, batch, use_beam)
    assert torch.equal(torch.cat([ids1, ids2]), want_ids)
    assert torch.equal(torch.cat([len1, len2]), want_len)
    before = logmel.log_mel_spectrogram_cuda.launches
    texts = served.transcribe(batch)
    assert logmel.log_mel_spectrogram_cuda.launches == before      # the CPU takes the plain version
    assert texts == t.transcribe(batch, use_beam)
    assert texts == JExported.load(jax_dir).transcribe(batch)
    with open(os.path.join(out_dir, "meta.json")) as f, \
            open(os.path.join(jax_dir, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    targets = {str(n.target) for n in served.program.graph.nodes if n.op == "call_function"}
    assert "mmav.log_mel.default" in targets                 # K1, one node
    decodes = [n for n in served.program.graph.nodes
               if str(n.target) == "mmav.prefix_beam.default"]
    assert len(decodes) == (1 if use_beam else 0)            # the whole beam search, one node
    assert not any("lip_preprocess" in x for x in targets)   # lips come preprocessed
    return served


def test_export_prefix_beam_with_lm_matches_transcriber_and_jax(setup, tmp_path):
    cfg, v, batch = setup
    cfg = copy.deepcopy(cfg)
    lm_path = str(tmp_path / "lm.npy")
    save_bigram_lm(lm_path, train_bigram_lm([[5, 6, 7]], cfg.model.decoder.vocab_size))
    cfg.decode.lm_path, cfg.decode.lm_weight, cfg.decode.length_bonus = lm_path, 0.3, 0.5
    jt = JTranscriber(cfg, JTokenizer(VOCAB), v, dtype=jnp.float32)
    j_export(jt, str(tmp_path / "jax"), batch, use_beam=True)

    t = _port_transcriber(cfg, v)
    assert t.lm is not None
    report = export_transcriber(t, str(tmp_path / "port"), batch, use_beam=True)
    for f in ("model.pt2", "meta.json", "vocab.txt", "lm.npy"):
        assert os.path.isfile(tmp_path / "port" / f), f
    assert report["nodes"] > 100 and report["bytes"] > 0 and report["seconds"] > 0
    served = _check_artifact(t, str(tmp_path / "port"), str(tmp_path / "jax"), batch, True)
    np.testing.assert_array_equal(served.lm.numpy(), np.load(lm_path))


def test_export_reads_the_lm_from_the_config(setup, tmp_path):
    """As JAX's, the export reads ``decode.lm_path`` when it runs: a
    Transcriber built before the path was set still exports the LM."""
    cfg, v, batch = setup
    cfg = copy.deepcopy(cfg)
    t = _port_transcriber(cfg, v)
    assert t.lm is None
    lm_path = str(tmp_path / "lm.npy")
    save_bigram_lm(lm_path, train_bigram_lm([[5, 6]], cfg.model.decoder.vocab_size))
    t.config.decode.lm_path = lm_path
    export_transcriber(t, str(tmp_path / "port"), batch)
    with open(tmp_path / "port" / "meta.json") as f:
        assert json.load(f)["has_lm"] is True
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "lm.npy"), np.load(lm_path))


def test_export_greedy_matches_transcriber_and_jax(setup, tmp_path):
    cfg, v, batch = setup
    jt = JTranscriber(cfg, JTokenizer(VOCAB), v, dtype=jnp.float32)
    j_export(jt, str(tmp_path / "jax"), batch, use_beam=False)
    t = _port_transcriber(cfg, v)
    export_transcriber(t, str(tmp_path / "port"), batch, use_beam=False)
    assert not os.path.exists(tmp_path / "port" / "lm.npy")
    _check_artifact(t, str(tmp_path / "port"), str(tmp_path / "jax"), batch, False)


def test_export_int8_greedy_matches_transcriber_and_jax(setup, tmp_path):
    """The int8 artifact holds the int8 tensors and their scales, not fp
    copies: its tensors are the bytes the int8 Transcriber holds."""
    cfg, v, batch = setup
    jt = JTranscriber(cfg, JTokenizer(VOCAB), v, dtype=jnp.float32, quantize=True,
                      quantize_min_size=256)
    j_export(jt, str(tmp_path / "jax"), batch, use_beam=False)
    t = _port_transcriber(cfg, v, quantize=True)
    export_transcriber(t, str(tmp_path / "port"), batch, use_beam=False)
    served = _check_artifact(t, str(tmp_path / "port"), str(tmp_path / "jax"), batch, False)
    held = served.program.state_dict
    n_int8 = sum(x.dtype == torch.int8 for x in held.values())
    assert n_int8 == len(t.forward.scales) > 0
    assert sum(x.numel() * x.element_size() for x in held.values()) == t.forward.nbytes


def test_artifact_refuses_another_device(setup, tmp_path):
    """An artifact computes on the device it was exported on; loading it for
    another raises rather than moving the run."""
    cfg, v, batch = setup
    export_transcriber(_port_transcriber(cfg, v), str(tmp_path), batch, use_beam=False)
    with pytest.raises(ValueError, match="computes on cpu, not on cuda"):
        ExportedTranscriber.load(str(tmp_path), device="cuda")


@pytest.mark.parametrize("kwargs", [
    dict(), dict(center=False, apply_log=False), dict(f_min=20.0, f_max=7600.0, n_mels=40)])
def test_log_mel_operator_passes_opcheck(kwargs):
    """Schema (no aliasing, no mutation), fake tensor against the CPU
    kernel, and AOT dispatch with dynamic shapes."""
    a = dict(sample_rate=16000, n_fft=400, hop_length=160, win_length=400, n_mels=80,
             f_min=0.0, f_max=None, log_eps=1e-6, center=True, apply_log=True)
    a.update(kwargs)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3000)).astype(np.float32))
    torch.library.opcheck(logmel.log_mel_op, (x,) + tuple(a.values()))
    out = logmel.log_mel_op(x, *a.values())
    assert out.shape == (2, logmel.num_frames(3000, 400, 160, a["center"]), a["n_mels"])


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_lip_operator_passes_opcheck(dtype):
    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 20, 28, 3)))
    torch.library.opcheck(resize.lip_preprocess_op, (frames.to(dtype), 12))
    assert resize.lip_preprocess_op(frames.to(dtype), 12).shape == (3, 1, 12, 12)


def test_wrappers_trace_to_one_node_each():
    """``torch.export`` of the two wrappers holds one operator node each;
    the 1-D waveform's batch axis is dropped outside the operator."""
    class Both(torch.nn.Module):
        def forward(self, wave, frames):
            return logmel.log_mel_spectrogram_cuda(wave), resize.lip_preprocess_cuda(frames, 8)

    wave = torch.zeros(4000)
    frames = torch.zeros(2, 16, 16, 3, dtype=torch.uint8)
    ep = torch.export.export(Both(), (wave, frames), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("mmav.log_mel.default") == 1
    assert targets.count("mmav.lip_preprocess.default") == 1
    mel, lips = ep.module()(wave, frames)
    assert mel.shape == (26, 80) and lips.shape == (2, 1, 8, 8)
