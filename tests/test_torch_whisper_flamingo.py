"""Whisper-Flamingo (``model.arch = "whisper_flamingo"``,
``multimodal_av_model_tpu_torch/models/whisper_flamingo.py``) against the
benchmark's plain reference (``avbench/reference/whisper_flamingo.py``), on the
CPU at a small size: 2 + 2 Whisper layers of 64 with 4 heads over a 2 s window
(200 mel frames, 100 encoder positions), a 2-layer AV-HuBERT video encoder of
64 on a 2-stage trunk, 16 video frames, a vocabulary of 300, with seeded
random weights and the real 80-bin Slaney front end; torch on one thread.

Tolerances, each about three times the widest gap read over 8 seeds of
weights and batches, and each from what the two sides compute:

* float32: the same products in other orders (the port's K2, fused ops and
  each mixture's cross-attention queried as one row of both speakers'
  queries): logits to 1e-4 absolute (read: 2e-6), the loss to 1e-5
  relative, the gradients to 1e-5 (read: 4e-7) and the Adam update to 2e-5
  (read: 3e-6), each the norm of the difference over the reference's norm
  over all the trainables together;
* bfloat16 against the float32 reference: 8 bits of mantissa in every
  product's operands, compounding over the layers: logits to 0.15 absolute
  (read: 0.056), the loss to 2e-3 relative (read: 5e-4), the gradients to
  0.03 (read: 0.011) and the update to 0.7 (read: 0.24).  The update is
  compared, at both precisions, on the elements whose reference gradient is
  at least a tenth of its leaf's root mean square: Adam's first step is
  ``lr * sign(g)`` wherever ``|g|`` is far above eps, so an element whose
  gradient is near zero flips with its rounding; in bfloat16 a few small
  leaves (the first gated block's LayerNorm, whose input is the frozen
  embedding) still carry most of the gap.
"""

import os

import numpy as np
import pytest
import torch

from avbench import traffic, weights
from avbench.reference import preprocess as ref_pre
from avbench.reference.train import Adam
from avbench.reference.whisper_flamingo import (
    WhisperFlamingoNet,
    ce_loss,
    labels,
    log_mel,
    sinusoids,
    slaney_filterbank,
)
from multimodal_av_model_tpu_torch.config import Config, to_dict
from multimodal_av_model_tpu_torch.data.device_pipeline import (
    IGNORE,
    device_preprocessed_batches,
    whisper_labels,
)
from multimodal_av_model_tpu_torch.models import build_av_model
from multimodal_av_model_tpu_torch.models.layers import MultiHeadAttention, sinusoidal_positions
from multimodal_av_model_tpu_torch.models.whisper_flamingo import (
    pipeline_options,
    whisper_sinusoids,
)
from multimodal_av_model_tpu_torch.ops import logmel
from multimodal_av_model_tpu_torch.train.trainer import MultiSpeakerTrainer, TrainState

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
# (logits, loss, gradients, update): see the docstring.
TOLERANCES = {"float32": (1e-4, 1e-5, 1e-5, 2e-5), "bfloat16": (0.15, 2e-3, 0.03, 0.7)}
LIP = 24
PROMPT, EOT = (296, 297, 298, 299), 295
MIX = {"batch": 2, "bucket": 16, "frames": [10, 16], "audio2_fraction": [0.6, 1.0],
       "crop": 24, "lip_size": LIP, "audio_samples_per_frame": 640, "label_len": [3, 6],
       "label_bucket": 8, "first_token": 0, "vocab": EOT, "pool": 2}


def tiny_config(dtype: str = "float32") -> Config:
    cfg = Config()
    m = cfg.model
    m.arch, m.dtype = "whisper_flamingo", dtype
    m.frontend.mel_scale = "slaney"
    w = m.whisper_flamingo
    w.n_audio_ctx, w.n_audio_state, w.n_audio_head, w.n_audio_layer = 100, 64, 4, 2
    w.n_text_ctx, w.n_text_state, w.n_text_head, w.n_text_layer = 16, 64, 4, 2
    w.n_vocab, w.video_dim, w.prompt, w.eot = 300, 64, PROMPT, EOT
    a = m.avhubert
    a.embed_dim, a.num_layers, a.num_heads, a.ffn_dim = 64, 2, 4, 128
    a.conv_pos, a.conv_pos_groups = 8, 4
    a.dropout = a.attention_dropout = a.activation_dropout = 0.0
    v = m.visual
    v.frontend_channels, v.resnet_layers, v.resnet_channels, v.output_dim = 8, (1, 1), (8, 16), 64
    cfg.data.audio_samples_per_video_frame = 640
    return cfg


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    cfg = tiny_config()
    model = build_av_model(cfg.model)
    P = weights.seeded_state_dict(dict(model.state_dict()), 11, "cpu")
    raw = traffic.raw_batches(MIX, 2024)[0]
    return cfg, P, raw


def _model(cfg, P):
    model = build_av_model(cfg.model, getattr(torch, cfg.model.dtype))
    model.load_state_dict(P)
    return model


def _batch(cfg, raw):
    (batch,) = device_preprocessed_batches([raw], out_size=LIP, device="cpu",
                                           **pipeline_options(cfg.model))
    return batch


def _forward(model, batch):
    return model(*[torch.as_tensor(batch[k]) for k in ("lip1", "lip2", "audio", "mask1",
                                                       "mask2", "lip1_lengths", "lip2_lengths")],
                 tokens1=batch["tokens1"], tokens2=batch["tokens2"])


def _reference(P, cfg, raw, trainable=()):
    """The reference's logits and loss, and the gradients of ``trainable``."""
    d = to_dict(cfg)["model"]
    params = {n: P[n].clone().requires_grad_() for n in trainable}
    net = WhisperFlamingoNet({**P, **params}, d)
    inp = ref_pre.model_inputs(raw, "cpu", LIP)
    rows = [labels(torch.from_numpy(raw["text" + s]), raw[f"text{s}_lengths"],
                   d["whisper_flamingo"]) for s in "12"]
    out = net.forward(inp, torch.cat([rows[0][0], rows[1][0]]))
    loss = ce_loss(out["logits"], torch.cat([rows[0][1], rows[1][1]]), out["B"])
    grads = (dict(zip(trainable, torch.autograd.grad(loss, [params[n] for n in trainable])))
             if trainable else {})
    return out["logits"].detach(), loss.detach(), grads


def _gap(got: dict, ref: dict, grads: dict | None = None) -> float:
    """``|got - ref| / |ref|`` over all the leaves together; with ``grads``
    only over the elements whose gradient is at least a tenth of its leaf's
    root mean square."""
    num = den = 0.0
    for n, r in ref.items():
        d = got[n].float() - r
        if grads is not None:
            keep = grads[n].abs() >= 0.1 * grads[n].pow(2).mean().sqrt()
            d, r = d[keep], r[keep]
        num, den = num + float((d * d).sum()), den + float((r * r).sum())
    return (num / den) ** 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_matches_reference(tiny, dtype, mode):
    """Eval: the logits and the loss of a forward without autograd.  Train:
    one ``train_step``'s logits and loss, the trainables' gradients and the
    Adam update, against the reference's step."""
    cfg32, P, raw = tiny
    cfg = tiny_config(dtype)
    model = _model(cfg, P)
    batch = _batch(cfg, raw)
    logits_tol, loss_tol, grad_tol, update_tol = TOLERANCES[dtype]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    ref_logits, ref_loss, ref_grads = _reference(P, cfg32, raw, names if mode == "train" else ())
    if mode == "eval":
        with torch.no_grad():
            out = _forward(model, batch)
        loss = sum(MultiSpeakerTrainer._token_ce(out["logits" + s], batch["targets" + s])
                   for s in "12") / 2
    else:
        trainer = MultiSpeakerTrainer(cfg, model, None, device="cpu")
        state = TrainState(0, model, trainer.make_optimizer(), torch.Generator().manual_seed(0))
        out = {}
        hook = model.register_forward_hook(lambda mod, args, o: out.update(o))
        state, metrics = trainer.train_step(state, batch)
        hook.remove()
        loss = metrics["loss"]
        assert _gap({n: model.get_parameter(n).grad for n in names}, ref_grads) <= grad_tol
        params = {n: P[n].clone() for n in names}
        Adam(params, {"learning_rate": cfg.train.learning_rate,
                      "audio_learning_rate": cfg.train.audio_learning_rate}).step(ref_grads)
        upd = {n: model.get_parameter(n).detach() - P[n] for n in names}
        assert _gap(upd, {n: params[n] - P[n] for n in names}, ref_grads) <= update_tol
    logits = torch.cat([out["logits1"], out["logits2"]]).detach()
    assert logits.dtype == torch.float32
    torch.testing.assert_close(logits, ref_logits, rtol=0, atol=logits_tol)
    torch.testing.assert_close(loss.detach().float(), ref_loss, rtol=loss_tol, atol=0)


def test_frozen_parts_take_no_gradient_and_no_adam_state(tiny):
    """Whisper and the video encoder hold no ``.grad`` after a step and no
    Adam state; their outputs carry no autograd graph; the step's trainables
    are the gated blocks and the video projection alone."""
    cfg, P, raw = tiny
    model = _model(cfg, P)
    trainer = MultiSpeakerTrainer(cfg, model, None, device="cpu")
    state = TrainState(0, model, trainer.make_optimizer(), torch.Generator().manual_seed(0))
    outs = {}
    for name in ("audio_encoder", "video_encoder"):
        getattr(model, name).register_forward_hook(
            lambda mod, args, o, name=name: outs.update({name: o}))
    state, _ = trainer.train_step(state, _batch(cfg, raw))
    assert all(o.grad_fn is None and not o.requires_grad for o in outs.values())
    adam_state = {p for p in state.optimizer.adam.state}
    for n, p in model.named_parameters():
        trains = n.startswith(("gated.", "video_proj."))
        assert p.requires_grad == trains, n
        assert (p.grad is not None) == trains, n
        assert (p in adam_state) == trains, n
    assert model.frozen_prefixes == ("audio_encoder.", "video_encoder.", "decoder.")


@pytest.mark.parametrize("gate", [0.0, 1.0])
def test_gates_let_the_lips_in(tiny, gate):
    """With both gates of every block at 0 the logits do not depend on the
    lips (tanh(0) = 0 adds exactly nothing); at 1 other lips move them by
    more than the bfloat16 logits' tolerance."""
    cfg, P, raw = tiny
    P = {**P, **{n: torch.full_like(t, gate) for n, t in P.items() if n.endswith("_gate")}}
    model = _model(cfg, P)
    batch = _batch(cfg, raw)
    other = dict(raw, lip1_raw=raw["lip1_raw"][::-1].copy(), lip2_raw=255 - raw["lip2_raw"])
    with torch.no_grad():
        a, b = _forward(model, batch), _forward(model, _batch(cfg, other))
    gap = max(float((a[k] - b[k]).abs().max()) for k in ("logits1", "logits2"))
    if gate == 0.0:
        assert gap == 0.0
    else:
        assert gap > TOLERANCES["bfloat16"][0]


@pytest.mark.parametrize("fault", [None, "mask_dropped"], ids=["as_built", "mask_dropped"])
def test_gated_probe_sees_query_key_and_mask(tiny, fault):
    """The benchmark's probe of the gated attention
    (``avbench/runners/train_whisper_flamingo.py``: a float32 copy of each
    probed gated block of the port and the reference's block, on the inputs
    and mask a forward gave the port's, with video features that differ
    from frame to frame): as built, the
    output and gradient gaps are f32 round-off at most (read: 0 over 8
    seeds, the two sides computing the same products here; bar 1e-5); with
    the padded frames attended (the calibration's ``mask_dropped`` fault)
    the widest gradient gap is far above that (read: 0.49-0.66)."""
    import contextlib
    import types

    from avbench.calibrate_whisper_flamingo import planted
    from avbench.runners import train_whisper_flamingo as runner

    cfg, P, raw = tiny
    model = _model(cfg, P)
    ctx = types.SimpleNamespace(device="cpu", model=to_dict(cfg)["model"], config=cfg,
                                mix={"bucket": MIX["bucket"]}, seed=5)
    x_in, masks = {}, {}

    def keep(i):
        def hook(mod, args):
            x_in[i], masks[i] = args[0].detach(), args[2]
        return hook

    hooks = [model.gated[i].register_forward_pre_hook(keep(i))
             for i in runner.probe_blocks(len(model.gated))]
    with planted(fault) if fault else contextlib.nullcontext():
        with torch.no_grad():
            _forward(model, _batch(cfg, raw))
        probe = runner.port_probe(ctx, model, x_in, masks)
    for h in hooks:
        h.remove()
    assert sorted(probe["x"]) == [0, 1]
    assert any(int(n) < MIX["bucket"] for n in raw["lip1_lengths"])     # frames to mask
    got, _ = runner.probe_compare(probe, runner.reference_probe(ctx, probe, raw), probe["x"])
    if fault is None:
        assert got["xattn_grad"] <= 1e-5 and got["xattn_out"] <= 1e-5
    else:
        assert got["xattn_grad"] > 0.1


def test_whisper_sinusoids_are_not_the_interleaved_table():
    """Whisper's table: sin in the first half of the channels, cos in the
    second, timescales ``exp(-ln(1e4) i / (C/2 - 1))``; the port's
    ``sinusoidal_positions`` interleaves them at ``exp(-ln(1e4) 2i / C)``."""
    pe = whisper_sinusoids(1500, 1280)
    torch.testing.assert_close(pe, sinusoids(1500, 1280, "cpu"), rtol=0, atol=0)
    t, i = 7, 5
    assert abs(float(pe[t, i]) - np.sin(t * np.exp(-np.log(1e4) * i / 639))) < 1e-6
    assert abs(float(pe[t, 640 + i]) - np.cos(t * np.exp(-np.log(1e4) * i / 639))) < 1e-6
    assert float((pe - sinusoidal_positions(1500, 1280)).abs().max()) > 1.0


def test_every_whisper_attention_has_a_key_without_bias(tiny):
    cfg, P, _ = tiny
    model = _model(cfg, P)
    whisper = [m for part in (model.audio_encoder, model.decoder, model.gated)
               for m in part.modules() if isinstance(m, MultiHeadAttention)]
    assert len(whisper) == 2 + 2 * 2 + 2
    for m in whisper:
        assert m.key.bias is None
        assert all(getattr(m, k).bias is not None for k in ("query", "value", "out"))
    assert not any(n.endswith("key.bias") for n in P if not n.startswith("video_encoder."))


def test_whisper_labels_give_prompt_shifted_targets_and_eot():
    text = np.array([[5, 6, 7, 0], [8, 0, 0, 0], [0, 0, 0, 0]])
    tokens, targets = whisper_labels(text, np.array([3, 1, 0]), (1, 2, 3), 9)
    I = IGNORE
    np.testing.assert_array_equal(tokens, [[1, 2, 3, 5, 6, 7, 9], [1, 2, 3, 8, 9, 9, 9],
                                           [1, 2, 3, 9, 9, 9, 9]])
    np.testing.assert_array_equal(targets, [[I, I, 5, 6, 7, 9, I], [I, I, 8, 9, I, I, I],
                                            [I, I, 9, I, I, I, I]])
    ref_tokens, ref_targets = labels(torch.from_numpy(text), [3, 1, 0],
                                     {"prompt": [1, 2, 3], "eot": 9})
    np.testing.assert_array_equal(tokens, ref_tokens.numpy())
    np.testing.assert_array_equal(targets, ref_targets.numpy())


def test_pipeline_pads_the_mixture_to_the_window_and_counts_targets(tiny):
    from multimodal_av_model_tpu_torch import tracing

    cfg, _, raw = tiny
    tracing.enable("cpu")
    try:
        with tracing.unit(0):
            batch = _batch(cfg, raw)
        spans = tracing.collect()
    finally:
        tracing.disable()
    window = 2 * cfg.model.whisper_flamingo.n_audio_ctx * cfg.model.frontend.hop_length
    S = raw["audio1"].shape[1]
    assert batch["audio"].shape == batch["mask1"].shape == (2, window)
    assert float(batch["audio"][:, S:].abs().max()) == 0.0
    assert int(batch["mask2"][:, S:].min()) == 3
    assert batch["tokens1"].shape == (2, len(PROMPT) + MIX["label_bucket"])
    counted = sum(s["counters"].get("decoder_tokens", 0) for s in spans)
    assert counted == int((raw["text1_lengths"] + 1).sum() + (raw["text2_lengths"] + 1).sum())


def _refusals():
    """Each path Whisper-Flamingo does not take, called with its
    configuration or model."""
    import types

    from multimodal_av_model_tpu_torch import main as cli
    from multimodal_av_model_tpu_torch.infer import Transcriber, export_transcriber
    from multimodal_av_model_tpu_torch.serve import AudioService
    from multimodal_av_model_tpu_torch.streaming import (
        StreamingAudioTranscriber,
        StreamingAVTranscriber,
    )
    from multimodal_av_model_tpu_torch.text import CharTokenizer

    def transcriber(cfg, model, **kw):
        return Transcriber(cfg, CharTokenizer(VOCAB), model, device="cpu", **kw)

    def trainer(cfg, model, **kw):
        return MultiSpeakerTrainer(cfg, model, CharTokenizer(VOCAB), device="cpu", **kw)

    def state(cfg, model):
        t = trainer(cfg, model)
        return t, TrainState(0, model, t.make_optimizer(), torch.Generator().manual_seed(0))

    def fit(cfg, model, tmp):
        cfg.train.checkpoint_dir = str(tmp)
        t, s = state(cfg, model)
        t.fit(s, lambda: [], lambda: [])

    def evaluate(cfg, model, tmp):
        t, s = state(cfg, model)
        t.evaluate([], s)

    def eval_step(cfg, model, tmp):
        t, s = state(cfg, model)
        t.eval_step(s, {})

    def train_epoch(cfg, model, tmp):
        t, s = state(cfg, model)
        t.train_epoch([], state=s)

    served = types.SimpleNamespace        # a stand-in whose config is Whisper-Flamingo's
    return {
        "transcriber": lambda cfg, model, tmp: transcriber(cfg, model),
        "int8": lambda cfg, model, tmp: transcriber(cfg, model, quantize=True),
        "export": lambda cfg, model, tmp: export_transcriber(served(config=cfg), str(tmp), {}),
        "service": lambda cfg, model, tmp: AudioService(served(config=cfg)),
        "streaming_av": lambda cfg, model, tmp: StreamingAVTranscriber(
            cfg, CharTokenizer(VOCAB), model, device="cpu"),
        "streaming_audio": lambda cfg, model, tmp: StreamingAudioTranscriber(
            cfg, CharTokenizer(VOCAB), model, device="cpu"),
        "mesh": lambda cfg, model, tmp: trainer(cfg, model, mesh=object()),
        "fit": fit,
        "evaluate": evaluate,
        "eval_step": eval_step,
        "train_epoch": train_epoch,
        "cli": lambda cfg, model, tmp: cli.main(["--device=cpu", "--synthetic",
                                                 "model.arch=whisper_flamingo"]),
        "cli_stream": lambda cfg, model, tmp: cli.main(
            ["--device=cpu", "--stream=x.wav", "model.arch=whisper_flamingo"]),
    }


@pytest.mark.parametrize("path", sorted(_refusals()))
def test_paths_not_taken_refuse_it(tiny, path, tmp_path):
    cfg, P, _ = tiny
    cfg = tiny_config()
    with pytest.raises((ValueError, SystemExit), match="whisper_flamingo"):
        _refusals()[path](cfg, _model(cfg, P), tmp_path)


# -- K1 at Whisper's front end ------------------------------------------------------


def test_slaney_table_matches_the_formula_and_its_properties():
    """The port's 80-bin Slaney table equals the reference's (written from
    librosa's formula), each filter's area is 1 (the sum of its weights
    times the 40 Hz bin spacing, within 3 % for filters of at least 5 bins), and below
    1 kHz the filters are the linear scale's: triangles of half-width ``d``
    centred on multiples of ``d``, ``d = (200/3) m_top / 81``, ``m_top`` the
    Slaney mel of 8 kHz."""
    fb = logmel.mel_filterbank(201, 80, 16000, mel_scale="slaney")
    np.testing.assert_allclose(fb, slaney_filterbank(400, 80, 16000), rtol=1e-6, atol=1e-9)
    support = (fb > 0).sum(axis=0)
    wide = support >= 5
    assert wide.sum() > 25
    np.testing.assert_allclose(fb[:, wide].sum(axis=0) * 40.0, 1.0, rtol=0.03)
    m_top = 15.0 + np.log(8000.0 / 1000.0) / (np.log(6.4) / 27.0)
    d = (200.0 / 3.0) * m_top / 81
    freqs = np.arange(201) * 40.0
    linear = [m for m in range(80) if (m + 2) * d < 1000.0]
    assert len(linear) > 15
    for m in linear:
        tri = np.clip(1.0 - np.abs(freqs - (m + 1) * d) / d, 0.0, None) / d
        np.testing.assert_allclose(fb[:, m], tri, rtol=1e-5, atol=1e-7)
    assert logmel.mel_support(201, 80, 16000, mel_scale="slaney")[1].shape == (80, 16)


def test_plain_k1_with_whisper_s_epilogue_matches_the_reference():
    """The port's front end of Whisper (K1's plain version at 80 Slaney bins,
    its last frame dropped, ``whisper_log_mel``) against the reference's
    ``torch.stft`` and filterbank on ``[2, 480000]``, in f32: the two sum
    the same power in other orders, and the features are ``log10`` / 4 of it."""
    from multimodal_av_model_tpu_torch.models.whisper_flamingo import WhisperAudioEncoder

    torch.set_num_threads(1)
    cfg = Config()
    cfg.model.frontend.mel_scale = "slaney"
    rng = np.random.default_rng(3)
    x = torch.from_numpy((0.3 * rng.standard_normal((2, 300000))).astype(np.float32))
    with torch.device("meta"):
        enc = WhisperAudioEncoder(cfg.model, torch.float32)
    got = enc.features(x)
    ref = log_mel(x, to_dict(cfg)["model"])
    assert got.shape == ref.shape == (2, 3000, 80)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    assert float(got[:, 2000:].max()) < float(got[:, :1800].min()) + 1e-6   # the padded tail


def _htk_before(n_freqs, n_mels, sample_rate, f_min=0.0, f_max=None):
    """``ops/logmel.py:mel_filterbank`` as it was before the Slaney table."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(logmel.hz_to_mel(f_min), logmel.hz_to_mel(f_max), n_mels + 2)
    f_pts = logmel.mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 26])
def test_htk_path_is_unchanged(n_mels):
    """The default (HTK) table, the kernel's supports and the plain K1 are bit
    for bit what they were, with or without ``mel_scale="htk"`` spelt out."""
    before = _htk_before(201, n_mels, 16000)
    for table in (logmel.mel_filterbank(201, n_mels, 16000),
                  logmel.mel_filterbank(201, n_mels, 16000, 0.0, None, "htk")):
        assert table.dtype == np.float32 and np.array_equal(table, before)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8000)).astype(np.float32))
    a = logmel.log_mel_spectrogram_cuda(x, n_mels=n_mels)
    assert torch.equal(a, logmel.log_mel_spectrogram(x, n_mels=n_mels, mel_scale="htk"))
    magsq = logmel.stft_magsq(x)
    assert torch.equal(a, torch.log(magsq @ torch.from_numpy(before) + 1e-6))


@pytest.mark.parametrize("train", [False, True], ids=["forward", "train_step"])
def test_flop_count_matches_the_flop_counter(tiny, train):
    """``avbench/flops_whisper_flamingo.py`` equals ``FlopCounterMode`` on the
    small model once the filterbank, inside K1's operator where the counter
    cannot see it, is left out: the forward, and the training step's
    backward that autograd runs (no backward through the frozen encoders,
    the audio cross-attention's query gradient alone)."""
    from torch.utils.flop_counter import FlopCounterMode

    from avbench import flops_whisper_flamingo

    cfg, P, raw = tiny
    model = _model(cfg, P)
    batch = _batch(cfg, raw)
    d = to_dict(cfg)["model"]
    shape = (MIX["batch"], MIX["bucket"], len(PROMPT) + MIX["label_bucket"], LIP)
    filterbank = flops_whisper_flamingo.forward_parts(d, *shape)["filterbank"][0]
    if train:
        trainer = MultiSpeakerTrainer(cfg, model, None, device="cpu")
        state = TrainState(0, model, trainer.make_optimizer(), torch.Generator().manual_seed(0))
        with FlopCounterMode(display=False) as counter:
            trainer.train_step(state, batch)
        ours = flops_whisper_flamingo.train_step(d, *shape)
    else:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            _forward(model, batch)
        ours = flops_whisper_flamingo.forward(d, *shape)
    assert counter.get_total_flops() == ours - filterbank
