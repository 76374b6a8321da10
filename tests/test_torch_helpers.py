"""PyTorch port, the last of the JAX package's small public functions, each
held against its JAX counterpart on the same numpy inputs:

* ``ops/metrics.py`` ``wer``, ``cer`` and ``text/korean.py``
  ``is_hangul_syllable``, ``jamo_error_rate`` (JAX's
  ``tests/test_metrics.py:15-39`` cases, ``str`` inputs and
  ``remove_spaces``): equal;
* ``data/mixing.py`` ``downsample_mask_nearest``: exact, ``target_len > S``
  and 2-D masks included;
* ``ops/ctc.py`` ``ctc_loss_from_logits``: loss and gradient with respect to
  the logits, rtol 1e-3, atol 1e-4 (``tests/test_ctc.py:102``'s bar);
* ``models/layers.py`` ``LSTMLayer`` on converted weights: rtol 1e-5, atol
  1e-6, as ``tests/test_bilstm.py:12-31`` holds the BiLSTM against two
  directions; padded outputs exactly 0;
* ``config.to_dict``: JAX's tree less the six fields the port drops;
* ``Tokenizer`` and the ``wer`` / ``cer`` exports, where JAX exports them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_av_model_tpu import config as jcfg
from multimodal_av_model_tpu.data.mixing import downsample_mask_nearest as j_downsample
from multimodal_av_model_tpu.models.layers import BiLSTM as JBiLSTM
from multimodal_av_model_tpu.models.layers import LSTMLayer as JLSTMLayer
from multimodal_av_model_tpu.ops.ctc import ctc_loss_from_logits as j_ctc_from_logits
from multimodal_av_model_tpu.ops.metrics import cer as j_cer
from multimodal_av_model_tpu.ops.metrics import wer as j_wer
from multimodal_av_model_tpu.text.korean import is_hangul_syllable as j_is_hangul
from multimodal_av_model_tpu.text.korean import jamo_error_rate as j_jamo_error_rate
from multimodal_av_model_tpu_torch import config as tcfg
from multimodal_av_model_tpu_torch import ops, text
from multimodal_av_model_tpu_torch.compat.from_jax import bilstm_from_jax
from multimodal_av_model_tpu_torch.data.mixing import downsample_mask_nearest
from multimodal_av_model_tpu_torch.models.layers import BiLSTM, LSTMLayer
from multimodal_av_model_tpu_torch.ops.ctc import ctc_loss_from_logits
from multimodal_av_model_tpu_torch.ops.metrics import cer, wer
from multimodal_av_model_tpu_torch.text.korean import is_hangul_syllable, jamo_error_rate
from test_torch_models import to_np

RATE_CASES = [
    ("a b c", "a b c", {}),
    ("a b c", "a x c", {}),
    ("a b c d", "a b", {}),
    (["a b", "c d e f"], ["a x", "c d e f"], {}),
    ("안녕하세요", "안녕하세요", {}),
    ("안녕하세요", "안녕하세유", {}),
    ("안녕 하세요", "안녕하세요", {"remove_spaces": True}),
    ("안녕  하세요 ", "안녕 하세요", {}),
    ("", "", {}),
    ("", "word", {}),
    (["가나 다", "라마"], ["가나다", "라 마 바"], {"remove_spaces": True}),
]


@pytest.mark.parametrize("ref,hyp,kw", RATE_CASES)
def test_wer_and_cer_equal_jax_s(ref, hyp, kw):
    assert wer(ref, hyp) == j_wer(ref, hyp)
    assert cer(ref, hyp, **kw) == j_cer(ref, hyp, **kw)


def test_known_rates():
    assert wer("a b c", "a x c") == 1 / 3 and wer(["a b", "c d e f"], ["a x", "c d e f"]) == 1 / 6
    assert cer("안녕하세요", "안녕하세유") == 1 / 5
    assert cer("안녕 하세요", "안녕하세요", remove_spaces=True) == 0.0
    assert cer("", "") == 0.0 and np.isinf(wer("", "word"))


@pytest.mark.parametrize("ref,hyp", [("안녕하세요", "안녕하세유"), ("각", "갂"),
                                     (["가나 다", "ab"], ["가나다", "ac"]), ("", ""),
                                     ("한국어", "")])
def test_jamo_error_rate_equals_jax_s(ref, hyp):
    assert jamo_error_rate(ref, hyp) == j_jamo_error_rate(ref, hyp)


def test_is_hangul_syllable_equals_jax_s():
    for ch in ["가", "힣", "ㄱ", "a", " ", "꯿", "힤", "한"]:
        assert is_hangul_syllable(ch) == j_is_hangul(ch), ch
    assert is_hangul_syllable("가") and not is_hangul_syllable("ㅏ")


@pytest.mark.parametrize("shape,target", [((97,), 31), ((3, 97), 10), ((3, 97), 48),
                                          ((3, 97), 97), ((2, 5), 13), ((4, 7), 100),
                                          ((2, 3, 50), 17)])
def test_downsample_mask_nearest_is_exact(shape, target):
    mask = np.random.default_rng(target).integers(0, 4, size=shape).astype(np.int32)
    got = downsample_mask_nearest(mask, target)
    want = j_downsample(mask, target)
    assert got.shape == want.shape == shape[:-1] + (target,) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_from_logits_and_its_logit_gradient_match_jax(reduction):
    rng = np.random.default_rng(3)
    B, T, V, L = 3, 12, 7, 4
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    labels = rng.integers(1, V, size=(B, L)).astype(np.int32)
    il = np.array([12, 9, 7], np.int32)
    ll = np.array([4, 2, 3], np.int32)

    def j_loss(lg):
        return j_ctc_from_logits(lg, labels, il, ll, blank_id=0, reduction=reduction).sum()

    j_val, j_grad = jax.value_and_grad(j_loss)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    loss = ctc_loss_from_logits(x, torch.from_numpy(labels), torch.from_numpy(il),
                                torch.from_numpy(ll), blank_id=0, reduction=reduction).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def bilstm():
    """A flax one-layer BiLSTM with non-zero recurrent biases, its port copy,
    and inputs with padded rows."""
    rng = np.random.default_rng(0)
    B, T, D, H = 3, 9, 6, 5
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([9, 6, 2], np.int32)
    jm = JBiLSTM(H, num_layers=1)
    v = to_np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths)))
    v["params"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a + rng.standard_normal(a.shape).astype(np.float32)
        if p[-1].key == "bias" else a, v["params"])
    port = BiLSTM(D, H, 1)
    port.load_state_dict(bilstm_from_jax(v), strict=True)
    return {"x": x, "lengths": lengths, "v": v, "jm": jm, "port": port}


@pytest.mark.parametrize("direction", [0, 1])
def test_lstm_layer_matches_jax_s(bilstm, direction):
    x, lengths = bilstm["x"], bilstm["lengths"]
    cell = bilstm["v"]["params"]["layer0"]["fwd" if direction == 0 else "bwd"]
    want = np.asarray(JLSTMLayer(5, reverse=direction == 1).apply(
        {"params": {"OptimizedLSTMCell_0": cell}}, jnp.asarray(x), jnp.asarray(lengths)))
    layer = LSTMLayer.from_fused(bilstm["port"].layers[0], direction)
    assert layer.reverse == (direction == 1)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for b, n in enumerate(lengths):
        assert (got[b, n:] == 0).all()
    with torch.no_grad():                       # no lengths: every frame valid
        full = layer(torch.from_numpy(x)).numpy()
    want_full = np.asarray(JLSTMLayer(5, reverse=direction == 1).apply(
        {"params": {"OptimizedLSTMCell_0": cell}}, jnp.asarray(x)))
    np.testing.assert_allclose(full, want_full, rtol=1e-5, atol=1e-6)


def test_two_lstm_layers_reproduce_the_bilstm(bilstm):
    x, lengths = torch.from_numpy(bilstm["x"]), torch.from_numpy(bilstm["lengths"])
    fused = bilstm["port"].layers[0]
    with torch.no_grad():
        both = torch.cat([LSTMLayer.from_fused(fused, 0)(x, lengths),
                          LSTMLayer.from_fused(fused, 1)(x, lengths)], -1)
        out = bilstm["port"](x, lengths)
    np.testing.assert_allclose(out.numpy(), both.numpy(), rtol=1e-5, atol=1e-6)
    ref = np.asarray(bilstm["jm"].apply(bilstm["v"], jnp.asarray(bilstm["x"]),
                                        jnp.asarray(bilstm["lengths"])))
    np.testing.assert_allclose(both.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_padding_is_inert_in_the_lstm_layer(bilstm):
    layer = LSTMLayer.from_fused(bilstm["port"].layers[0], 1)
    x, lengths = torch.from_numpy(bilstm["x"]), torch.from_numpy(bilstm["lengths"])
    noisy = x.clone()
    noisy[1, 6:] = 100.0
    with torch.no_grad():
        a, b = layer(x, lengths), layer(noisy, lengths)
    torch.testing.assert_close(a[1, :6], b[1, :6], rtol=0, atol=0)


def _leaves(d, prefix=""):
    out = {}
    for k, v in d.items():
        out.update(_leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


# The fields the port drops (``multimodal_av_model_tpu_torch/config.py``'s
# docstring): one the port decides by the tensor's device, five that neither
# package reads.
DROPPED = {"model.frontend.use_pallas", "train.keep_checkpoints", "model.frontend.power",
           "model.audio.max_len", "model.visual.image_size", "model.decoder.input_dim"}


def test_to_dict_is_jax_s_less_the_dropped_fields():
    cfg = tcfg.from_flat_overrides(["train.batch_size=16", "model.audio.middle_layers=(2,3)",
                                    "model.shared_audio_pass=false"])
    j = jcfg.from_flat_overrides(["train.batch_size=16", "model.audio.middle_layers=(2,3)",
                                  "model.shared_audio_pass=false"])
    got, want = _leaves(tcfg.to_dict(cfg)), _leaves(jcfg.to_dict(j))
    assert set(want) - set(got) == DROPPED
    # The port's own fields: the model selector, the AV-HuBERT and
    # Whisper-Flamingo blocks and the filterbank's mel scale.
    added = {k for k in got if k in ("model.arch", "model.frontend.mel_scale")
             or k.startswith(("model.avhubert.", "model.whisper_flamingo."))}
    assert added and got["model.arch"] == "flagship"
    assert got["model.frontend.mel_scale"] == "htk"
    assert set(got) - added <= set(want)
    for k, v in got.items():
        if k not in added:
            assert v == want[k], k
    assert tcfg.to_dict(tcfg.Config())["train"]["batch_size"] == 8


@pytest.mark.parametrize("path", sorted(DROPPED))
def test_a_dropped_field_s_override_fails_as_unknown(path):
    jcfg.from_flat_overrides([f"{path}=1"])               # JAX parses it
    with pytest.raises(AttributeError, match="unknown config field"):
        tcfg.from_flat_overrides([f"{path}=1"])


def test_exports_where_jax_exports_them():
    assert text.Tokenizer is text.CharTokenizer
    assert ops.wer is wer and ops.cer is cer
    assert "Tokenizer" in text.__all__ and {"wer", "cer"} <= set(ops.__all__)
