"""PyTorch port, int8 weight-only serving: ``ops/quantize.py`` and the
quantized ``Transcriber`` / ``AudioTranscriber``, held against the JAX
package (CPU, f32, tiny widths).

The int8 values equal JAX's byte for byte and the scales exactly, after the
layout change of ``compat/from_jax.py``, including ``min_size`` values that
put 3-D leaves (attention, the convolutions) and single LSTM gate blocks on
both sides of the bar; the quantized forward matches JAX's quantized forward
within 2e-4 and the texts are equal."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu.infer import AudioTranscriber as JAudioTranscriber
from multimodal_av_model_tpu.infer import Transcriber as JTranscriber
from multimodal_av_model_tpu.models import AudioOnlyCTC as JAudioOnly
from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
from multimodal_av_model_tpu.ops.quantize import quantize_variables, tree_bytes
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu_torch.compat import audio_only_from_jax, from_jax_variables
from multimodal_av_model_tpu_torch.infer import AudioTranscriber, Transcriber
from multimodal_av_model_tpu_torch.models import AudioOnlyCTC, MultiSpeakerAVModel
from multimodal_av_model_tpu_torch.ops.quantize import (
    dequantize,
    kernel_layouts,
    quantization_report,
    quantize_state_dict,
)
from multimodal_av_model_tpu_torch.text import CharTokenizer
from test_models import tiny_config
from test_torch_models import _av_inputs, perturb_batch_stats, port_config

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


def _cfg(norm="batch"):
    cfg = tiny_config()
    cfg.model.decoder.vocab_size = 800
    cfg.model.visual.norm = norm
    return cfg


@pytest.fixture(scope="module")
def flagship():
    """A tiny JAX flagship's variables (non-trivial BatchNorm statistics) and
    an example batch."""
    cfg = _cfg()
    inputs = _av_inputs()
    v = perturb_batch_stats(jax.jit(JModel(cfg.model).init)(jax.random.PRNGKey(3),
                                                   *map(jnp.asarray, inputs)))
    return cfg, v, dict(zip(KEYS, inputs))


@pytest.fixture(scope="module")
def audio_only():
    cfg = _cfg()
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    mask = np.ones((2, 4000), bool)
    mask[1, 2500:] = False
    v = JAudioOnly(cfg.model).init(jax.random.PRNGKey(4), jnp.asarray(audio), None)
    return cfg, jax.tree.map(np.asarray, v), audio, mask


def _port_flagship(cfg, variables):
    model = MultiSpeakerAVModel(port_config(cfg).model)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _jax_leaf_map(params, fn):
    """``params`` with each leaf ``x`` at flax path ``p`` replaced by
    ``fn(p, x)`` (f32 numpy)."""
    def walk(tree, prefix):
        return {k: (walk(v, prefix + (k,)) if hasattr(v, "items")
                    else np.asarray(fn("/".join(prefix + (k,)), np.asarray(v)), np.float32))
                for k, v in tree.items()}
    return walk(params, ())


@pytest.mark.parametrize("min_size", [1, 300, 4096])
def test_int8_values_and_scales_equal_jax(flagship, min_size):
    """min_size 300 on the tiny model: the fusion's attention (16x16 leaves)
    and the first BiLSTM layer's gate blocks (16x16) stay fp though their
    packed tensors hold 2,048 elements, the second layer's input gates
    (32x16) are quantized; the depthwise conv (7x1x32) stays fp, the audio
    attention (32x2x16) and the subsampling conv (5x80x32) are quantized."""
    cfg, v, _ = flagship
    qv, scales = quantize_variables(v, min_size)      # eagerly, as JAX serving does
    model = _port_flagship(cfg, v)
    layouts = kernel_layouts(model)
    qstate, pscales = quantize_state_dict(model.state_dict(), layouts, min_size)

    flags = from_jax_variables({"params": _jax_leaf_map(
        qv["params"], lambda p, x: np.full(x.shape, float(x.dtype == np.int8)))})
    values = from_jax_variables(qv)
    full_scales = from_jax_variables({"params": _jax_leaf_map(
        qv["params"], lambda p, x: (np.broadcast_to(scales[p], x.shape) if p in scales
                                    else np.zeros(x.shape)))})
    assert scales and pscales
    for name, q in qstate.items():
        if name not in flags:                           # BatchNorm statistics
            assert name not in pscales and torch.equal(q, model.state_dict()[name])
            continue
        f = flags[name]
        assert torch.equal(f, torch.full_like(f, f.flatten()[0])), name   # all or none
        if f.flatten()[0] == 0:
            assert name not in pscales and q.dtype == torch.float32, name
            continue
        assert q.dtype == torch.int8, name
        assert torch.equal(q, values[name].to(torch.int8)), name          # byte-equal
        assert torch.equal(values[name], values[name].round()), name
        s = torch.broadcast_to(pscales[name], layouts[name].view).reshape(q.shape)
        assert torch.equal(s, full_scales[name]), name
    if min_size == 300:
        assert "fusion.temporal_bilstm.layers.0.w_hh" not in pscales
        assert "fusion.temporal_bilstm.layers.1.w_ih" in pscales
        assert "fusion.cross_attn_audio.out.weight" not in pscales
        assert "audio_encoder.blocks.0.attn.out.weight" in pscales
        assert "audio_encoder.blocks.0.conv.depthwise_weight" not in pscales
        assert "audio_encoder.subsample_weight" in pscales


def test_round_trip_error_bound_and_report():
    """|w - dq(q(w))| <= s / 2 elementwise, s = max|w| / 127 over the group."""
    cfg = _cfg()
    model = AudioOnlyCTC(port_config(cfg).model)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    layouts = kernel_layouts(model)
    state = model.state_dict()
    qstate, scales = quantize_state_dict(state, layouts, 256)
    for name, s in scales.items():
        w = state[name].reshape(layouts[name].view)
        dq = dequantize(qstate[name], s, layouts[name].view, torch.float32).reshape(w.shape)
        assert ((dq - w).abs() <= s / 2 + 1e-6).all(), name
    rep = quantization_report(state, qstate, scales)
    assert rep["n_quantized"] == len(scales) and rep["vs_fp32"] > 2.5


def test_quantized_flagship_matches_jax(flagship):
    """The int8 Transcriber: the fp copy is gone (the module is on the meta
    device), the bytes held are JAX's, every dequantized tensor is the plain
    dequantization, log-probs within 2e-4 of JAX's quantized forward, texts
    equal."""
    cfg, v, batch = flagship
    tok, jtok = CharTokenizer(VOCAB), JTokenizer(VOCAB)
    jt = JTranscriber(cfg, jtok, v, dtype=jnp.float32, quantize=True, quantize_min_size=256)
    t = Transcriber(port_config(cfg), tok, _port_flagship(cfg, v), device="cpu", quantize=True,
                    quantize_min_size=256)
    assert all(p.is_meta for p in t.model.parameters())
    q = t.forward
    assert q.nbytes == tree_bytes(jt.qvariables) + tree_bytes(jt.scales)
    for name, d in q.dequantized().items():
        if name in q.scales:
            view = q.layouts[name].view
            plain = (q.qstate[name].reshape(view).float() * q.scales[name]).reshape(d.shape)
            assert torch.equal(d, plain), name
    ref = jt._forward(*jt._fwd_args, *(batch[k] for k in KEYS))
    with torch.no_grad():
        out = q(*(torch.from_numpy(batch[k]) for k in KEYS))
    for s in ("1", "2"):
        np.testing.assert_array_equal(out["input_lengths" + s].numpy(),
                                      np.asarray(ref["input_lengths" + s]))
        for b, n in enumerate(out["input_lengths" + s].tolist()):
            np.testing.assert_allclose(out["log_probs" + s][b, :n].numpy(),
                                       np.asarray(ref["log_probs" + s])[b, :n],
                                       rtol=2e-4, atol=2e-4)
    assert t.transcribe(batch) == jt.transcribe(batch)


@pytest.mark.parametrize("quantize", [False, True])
def test_audio_transcriber_matches_jax(audio_only, quantize):
    """``AudioOnlyCTC`` (loaded strictly through ``audio_only_from_jax``) and
    ``AudioTranscriber``, fp and int8: log-probs within 2e-4, lengths and
    texts equal (greedy and prefix beam)."""
    cfg, v, audio, mask = audio_only
    tok, jtok = CharTokenizer(VOCAB), JTokenizer(VOCAB)
    model = AudioOnlyCTC(port_config(cfg).model)
    model.load_state_dict(audio_only_from_jax(v), strict=True)
    jt = JAudioTranscriber(cfg, jtok, v, dtype=jnp.float32, quantize=quantize,
                           quantize_min_size=256)
    t = AudioTranscriber(port_config(cfg), tok, model, device="cpu", quantize=quantize,
                         quantize_min_size=256)
    lp, n = jt._forward(*jt._fwd_args, jnp.asarray(audio), jnp.asarray(mask))
    with torch.no_grad():
        got, got_n = t.forward(torch.from_numpy(audio), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(n))
    for b, k in enumerate(got_n.tolist()):
        np.testing.assert_allclose(got[b, :k].numpy(), np.asarray(lp)[b, :k], rtol=2e-4,
                                   atol=2e-4)
    for use_beam in (False, True):
        assert t.transcribe(audio, mask, use_beam) == jt.transcribe(audio, mask, use_beam)
