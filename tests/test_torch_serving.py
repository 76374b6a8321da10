"""PyTorch port, serving half: greedy and prefix-beam decoding held exactly
against the JAX decoders on the same log-probs, and ``Transcriber.transcribe``
texts held against the JAX ``Transcriber`` with the same weights (CPU, f32,
tiny widths)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu.infer import Transcriber as JTranscriber
from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
from multimodal_av_model_tpu.ops.beam_search import beam_search_decode as j_ref_beam
from multimodal_av_model_tpu.ops.ctc import ctc_greedy_decode as j_greedy
from multimodal_av_model_tpu.ops.prefix_beam_search import prefix_beam_search_decode as j_beam
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu_torch.compat import from_jax_variables
from multimodal_av_model_tpu_torch.data.collate import collate_pairs_raw, make_bucket_specs
from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches
from multimodal_av_model_tpu_torch.infer import Transcriber, decode_ids
from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
from multimodal_av_model_tpu_torch.ops.ctc import ctc_collapse, ctc_greedy_decode
from multimodal_av_model_tpu_torch.ops.prefix_beam_search import prefix_beam_search_decode
from multimodal_av_model_tpu_torch.text import CharTokenizer
from test_models import tiny_config
from test_torch_models import _av_inputs, perturb_batch_stats, port_config

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")


def _log_probs(B, T, V, seed, quantized=False):
    """Seeded log-softmaxed scores; ``quantized`` rounds the logits so equal
    scores (ties) are common."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)) * 3.0
    logits[..., 3] += 2.0                                   # blank-heavy, like CTC output
    if quantized:
        logits = np.round(logits)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lens = rng.integers(1, T + 1, size=B).astype(np.int32)
    lens[0] = T
    return lp.astype(np.float32), lens


@pytest.mark.parametrize("quantized", [False, True])
def test_greedy_ids_match_jax(quantized):
    lp, lens = _log_probs(4, 30, 12, seed=1, quantized=quantized)
    ids, n = ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(lens), 3)
    j_ids, j_n = j_greedy(jnp.asarray(lp), jnp.asarray(lens), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(j_n))


def test_ctc_collapse_small_case():
    ids = torch.tensor([[5, 5, 3, 5, 6, 6, 3, 3, 7]])
    out, n = ctc_collapse(ids, torch.tensor([8]), blank_id=3)
    assert n.tolist() == [3] and out[0, :4].tolist() == [5, 5, 6, -1]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("use_lm", [False, True])
def test_prefix_beam_ids_match_jax(quantized, use_lm):
    """Ids and lengths exact; scores to 1e-4 (f32 exp/log in two libraries).
    The quantized case has ties in every frame's top-K and in the beam
    ranking, which both sides break toward the lower index."""
    B, T, V = 4, 25, 30
    lp, lens = _log_probs(B, T, V, seed=2, quantized=quantized)
    lm = None
    kw = {}
    if use_lm:
        rng = np.random.default_rng(3)
        table = rng.standard_normal((V + 1, V))
        lm = (table - np.log(np.exp(table).sum(-1, keepdims=True))).astype(np.float32)
        kw = dict(lm_weight=0.5, length_bonus=0.3)
    ids, n, score = prefix_beam_search_decode(
        torch.from_numpy(lp), torch.from_numpy(lens), 5, 8, 3,
        lm=None if lm is None else torch.from_numpy(lm), **kw)
    j_ids, j_n, j_score = j_beam(jnp.asarray(lp), jnp.asarray(lens), beam_width=5, top_k=8,
                                 blank_id=3, lm=None if lm is None else jnp.asarray(lm), **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(j_n))
    np.testing.assert_allclose(score.numpy(), np.asarray(j_score), rtol=1e-4, atol=1e-4)


def test_decode_ids_dispatch():
    cfg = port_config(tiny_config())
    lp, lens = _log_probs(2, 10, 12, seed=4)
    lp, lens = torch.from_numpy(lp), torch.from_numpy(lens)
    g_ids, _ = ctc_greedy_decode(lp, lens, 3)
    assert torch.equal(decode_ids(cfg, lp, lens, use_beam=False)[0], g_ids)
    cfg.decode.algorithm = "reference_beam"
    r_ids, r_n, _ = j_ref_beam(jnp.asarray(lp.numpy()), jnp.asarray(lens.numpy()), 5, 3)
    ids, n = decode_ids(cfg, lp, lens)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(r_n))
    cfg.decode.algorithm = "no_such_decoder"
    with pytest.raises(ValueError, match="unknown decode algorithm"):
        decode_ids(cfg, lp, lens)


@pytest.mark.parametrize("use_beam", [True, False])
def test_transcribe_texts_match_jax(use_beam):
    """Same weights (through the bridge), same batch: identical texts."""
    tok = CharTokenizer(VOCAB)
    cfg = tiny_config()
    cfg.model.visual.norm = "batch"
    inputs = _av_inputs(seed=11)
    v = perturb_batch_stats(JModel(cfg.model).init(jax.random.PRNGKey(12),
                                                   *map(jnp.asarray, inputs)))
    keys = ("lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")
    batch = dict(zip(keys, inputs))
    ref = JTranscriber(cfg, JTokenizer(VOCAB), v, dtype=jnp.float32).transcribe(batch, use_beam)

    pcfg = port_config(cfg)
    model = MultiSpeakerAVModel(pcfg.model)
    model.load_state_dict(from_jax_variables(v), strict=True)
    got = Transcriber(pcfg, tok, model, device="cpu").transcribe(batch, use_beam)
    assert got == ref
    assert len(got) == 2 and all(isinstance(s, str) for pair in got for s in pair)


def test_transcribe_with_fusion_lm_matches_jax(tmp_path):
    """A bigram table through ``decode.lm_path`` (shallow fusion in the prefix
    beam): identical texts; a table of the wrong shape is refused."""
    tok = CharTokenizer(VOCAB)
    cfg = tiny_config()
    inputs = _av_inputs(seed=14)
    v = perturb_batch_stats(JModel(cfg.model).init(jax.random.PRNGKey(15),
                                                   *map(jnp.asarray, inputs)))
    V = cfg.model.decoder.vocab_size
    table = np.random.default_rng(16).standard_normal((V + 1, V))
    lm = (table - np.log(np.exp(table).sum(-1, keepdims=True))).astype(np.float32)
    cfg.decode.lm_path = str(tmp_path / "lm.npy")
    cfg.decode.lm_weight, cfg.decode.length_bonus = 0.5, 0.2
    np.save(cfg.decode.lm_path, lm)
    keys = ("lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")
    batch = dict(zip(keys, inputs))
    ref = JTranscriber(cfg, JTokenizer(VOCAB), v, dtype=jnp.float32).transcribe(batch)

    pcfg = port_config(cfg)
    model = MultiSpeakerAVModel(pcfg.model)
    model.load_state_dict(from_jax_variables(v), strict=True)
    assert Transcriber(pcfg, tok, model, device="cpu").transcribe(batch) == ref

    np.save(cfg.decode.lm_path, lm[:V])                     # no BOS row
    with pytest.raises(ValueError, match="bigram"):
        Transcriber(port_config(cfg), tok, model, device="cpu")


def test_serving_path_end_to_end_on_cpu():
    """Raw samples -> collate -> on-device preprocessing -> transcribe, the
    path chip_smoke.py drives on the card, here at tiny widths on the CPU."""
    from multimodal_av_model_tpu_torch.models import init_weights

    rng = np.random.default_rng(13)
    spec = make_bucket_specs((8,), 534, 6)[0]
    samples = [{
        "lip1_raw": rng.integers(0, 256, size=(t, 32, 32, 3), dtype=np.uint8),
        "lip2_raw": rng.integers(0, 256, size=(t, 32, 32, 3), dtype=np.uint8),
        "audio1": rng.standard_normal(t * 534).astype(np.float32),
        "audio2": rng.standard_normal(t * 400).astype(np.float32),
        "label1": [5, 6], "label2": [7],
    } for t in (8, 5)]
    (batch,) = device_preprocessed_batches([collate_pairs_raw(samples, spec)],
                                           out_size=24, device="cpu")
    cfg = port_config(tiny_config())
    model = init_weights(MultiSpeakerAVModel(cfg.model), torch.Generator().manual_seed(0))
    texts = Transcriber(cfg, CharTokenizer(VOCAB), model, device="cpu").transcribe(batch)
    assert len(texts) == 2 and all(isinstance(s, str) for pair in texts for s in pair)
