"""AV-HuBERT with a CTC head (``model.arch = "avhubert"``,
``multimodal_av_model_tpu_torch/models/avhubert.py``) against the benchmark's
plain reference (``avbench/reference/avhubert.py``), on the CPU at a small
width (2 layers of 64, 4 heads, a 2-stage trunk, conv_pos 8 in 4 groups) with
seeded random weights, all in float32, torch on one thread.

Tolerances: f32 on both sides, the two computing the same products in other
orders (the port's K2 and fused ops against the reference's matrices), so
log-probabilities agree to 1e-4 absolute and each gradient to 1e-3 relative
(the norm of the difference over the reference's norm) for every tensor whose
reference gradient is above f32 noise: at least a thousandth of the median
tensor's norm (below it the gradient is rounding)."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avbench import traffic, weights
from avbench.reference import preprocess as ref_pre
from avbench.reference.avhubert import AVHubertNet, ctc_losses
from multimodal_av_model_tpu_torch.config import Config, to_dict
from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches
from multimodal_av_model_tpu_torch.infer import Transcriber, decode_ids, export_transcriber
from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel, build_av_model
from multimodal_av_model_tpu_torch.models.avhubert import (
    PositionalConv,
    masked_utterance_norm,
    stack_frames,
)
from multimodal_av_model_tpu_torch.text import CharTokenizer
from multimodal_av_model_tpu_torch.train.trainer import MultiSpeakerTrainer, TrainState

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
LP_ATOL = 1e-4
GRAD_RTOL = 1e-3
LIP = 24
MIX = {"batch": 2, "bucket": 12, "frames": [6, 12], "audio2_fraction": [0.6, 1.0],
       "crop": 24, "lip_size": LIP, "audio_samples_per_frame": 640, "label_len": 3,
       "label_bucket": 6, "first_token": 4, "vocab": 30, "pool": 2}


def tiny_config() -> Config:
    cfg = Config()
    m = cfg.model
    m.arch, m.dtype = "avhubert", "float32"
    m.frontend.n_mels, m.frontend.center = 26, False
    a = m.avhubert
    a.embed_dim, a.num_layers, a.num_heads, a.ffn_dim = 64, 2, 4, 128
    a.conv_pos, a.conv_pos_groups = 8, 4
    a.dropout = a.attention_dropout = a.activation_dropout = 0.0
    v = m.visual
    v.frontend_channels, v.resnet_layers, v.resnet_channels, v.output_dim = 8, (1, 1), (8, 16), 64
    m.decoder.vocab_size = 30
    cfg.data.audio_samples_per_video_frame = 640
    return cfg


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    cfg = tiny_config()
    model = build_av_model(cfg.model)
    P = weights.seeded_state_dict(dict(model.state_dict()), 11, "cpu")
    model.load_state_dict(P)
    raw = traffic.raw_batches(MIX, 2024)[0]
    return cfg, model, P, raw


def _batch(raw):
    (batch,) = device_preprocessed_batches([raw], out_size=LIP, device="cpu")
    return batch


def _forward(model, batch):
    return model(*[torch.as_tensor(batch[k]) for k in ("lip1", "lip2", "audio", "mask1",
                                                       "mask2", "lip1_lengths", "lip2_lengths")])


def _reference(P, cfg, raw, train=False):
    d = to_dict(cfg)["model"]
    inp = ref_pre.model_inputs(raw, "cpu", LIP)
    fbank = ref_pre.log_mel(inp["audio"], d["frontend"])
    return AVHubertNet(P, d, train=train), inp, fbank, d


def _valid_rows(out, lp_key, len_key):
    return [(out[lp_key][r, :int(out[len_key][r])]) for r in range(out[lp_key].shape[0])]


def test_forward_log_probs_match_reference(tiny):
    cfg, model, P, raw = tiny
    with torch.no_grad():
        out = _forward(model.eval(), _batch(raw))
        net, inp, fbank, _ = _reference(P, cfg, raw)
        ref = net.forward(inp, fbank)
    B = out["log_probs1"].shape[0]
    for s, rows in (("1", slice(0, B)), ("2", slice(B, 2 * B))):
        np.testing.assert_array_equal(out["input_lengths" + s].numpy(),
                                      ref["input_lengths"][rows].numpy())
        for r, lp in enumerate(_valid_rows(out, "log_probs" + s, "input_lengths" + s)):
            ref_lp = ref["log_probs"][rows][r, :lp.shape[0]]
            torch.testing.assert_close(lp, ref_lp, rtol=0, atol=LP_ATOL)


def test_train_step_loss_and_gradients_match_reference(tiny):
    cfg, model, P, raw = tiny
    model = build_av_model(cfg.model)
    model.load_state_dict(P)
    trainer = MultiSpeakerTrainer(cfg, model, CharTokenizer(VOCAB), device="cpu")
    state = TrainState(0, model, trainer.make_optimizer(), torch.Generator().manual_seed(0))
    batch = _batch(raw)
    state, metrics = trainer.train_step(state, batch)
    assert float(metrics["contrast1"]) == float(metrics["contrast2"]) == 0.0
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}

    names = [n for n, p in model.named_parameters()]
    params = {n: P[n].clone().requires_grad_() for n in names}
    net, inp, fbank, d = _reference({**P, **params}, cfg, raw, train=True)
    labels = {k: torch.from_numpy(raw[k]) for k in ("text1", "text1_lengths", "text2",
                                                    "text2_lengths")}
    loss = ctc_losses(net.forward(inp, fbank), labels, d)
    ref = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
    torch.testing.assert_close(metrics["loss"], loss.detach(), rtol=1e-5, atol=0)

    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in ref.items()}
    median = float(np.median(list(norms.values())))
    kept = [n for n in names if norms[n] >= 1e-3 * median]
    assert len(kept) > 0.9 * len(names)
    worst = max((float(torch.linalg.vector_norm(grads[n] - ref[n])) / norms[n], n) for n in kept)
    assert worst[0] <= GRAD_RTOL, worst

    loss_eval, wer, cer, _ = trainer.evaluate([batch], state, use_beam=False)
    assert np.isfinite(loss_eval) and 0.0 <= cer


def test_a_padded_row_gives_its_unpadded_log_probs(tiny):
    cfg, model, _, raw = tiny
    mix = {**MIX, "frames": 7, "audio2_fraction": 1.0}
    padded = traffic.raw_batches(mix, 7)[0]
    T, spf = 7, MIX["audio_samples_per_frame"]
    alone = {k: v[:1] for k, v in padded.items()}
    for s in "12":
        alone["lip" + s + "_raw"] = alone["lip" + s + "_raw"][:, :T]
        alone["audio" + s] = alone["audio" + s][:, :T * spf]
    with torch.no_grad():
        long = _forward(model.eval(), _batch(padded))
        short = _forward(model.eval(), _batch(alone))
    assert long["log_probs1"].shape[1] == MIX["bucket"] and short["log_probs1"].shape[1] == T
    for s in "12":
        torch.testing.assert_close(long["log_probs" + s][0, :T], short["log_probs" + s][0],
                                   rtol=0, atol=LP_ATOL)


def test_weight_normed_samepad_conv_is_fairseq_s():
    """``PositionalConv`` against ``nn.Conv1d`` under torch's weight norm
    over dim 2 (fairseq's ``pos_conv``: g ``[1, 1, k]``), SamePad and GELU."""
    torch.manual_seed(0)
    D, k, groups, T = 16, 8, 4, 11
    port = PositionalConv(D, k, groups, torch.float32)
    with torch.no_grad():
        port.weight_v.normal_()
        port.weight_g.uniform_(0.5, 2.0)
        port.bias.normal_()
    conv = torch.nn.Conv1d(D, D, k, padding=k // 2, groups=groups)
    conv = torch.nn.utils.parametrizations.weight_norm(conv, name="weight", dim=2)
    with torch.no_grad():
        conv.parametrizations.weight.original0.copy_(port.weight_g.view(1, 1, k))
        conv.parametrizations.weight.original1.copy_(port.weight_v)
        conv.bias.copy_(port.bias)
    x = torch.randn(3, T, D)
    want = F.gelu(conv(x.transpose(1, 2))[..., :-1]).transpose(1, 2)
    torch.testing.assert_close(port(x), want, rtol=1e-5, atol=1e-5)


def test_stacking_and_masked_normalisation():
    """``stack_frames`` is AV-HuBERT's ``stacker`` (zero rows, then 4 frames
    side by side) and ``masked_utterance_norm`` is ``F.layer_norm`` over each
    row's valid ``[T, F]`` block, padded frames 0."""
    feats = torch.arange(2 * 9 * 3, dtype=torch.float32).reshape(2, 9, 3)
    got = stack_frames(feats, 4)
    for b in range(2):
        f = np.concatenate([feats[b].numpy(), np.zeros((3, 3), np.float32)])
        np.testing.assert_array_equal(got[b].numpy(), f.reshape(-1, 4, 3).reshape(-1, 12))
    x = torch.randn(3, 6, 5) * 3 + 1
    lengths = torch.tensor([6, 2, 4])
    valid = torch.arange(6)[None] < lengths[:, None]
    y = masked_utterance_norm(x, valid)
    for r, n in enumerate(lengths.tolist()):
        torch.testing.assert_close(y[r, :n], F.layer_norm(x[r, :n], (n, 5), eps=1e-5))
        assert not y[r, n:].any()


def test_transcriber_serves_it(tiny):
    cfg, model, P, raw = tiny
    t = Transcriber(cfg, CharTokenizer(VOCAB), model, device="cpu")
    texts = t.transcribe(_batch(raw))
    assert len(texts) == MIX["batch"]
    with torch.no_grad():
        net, inp, fbank, _ = _reference(P, cfg, raw)
        ref = net.forward(inp, fbank)
    ids, lens = decode_ids(cfg, ref["log_probs"], ref["input_lengths"].to(torch.int32))
    tok = CharTokenizer(VOCAB)
    want = [tok.decode(ids[r, :lens[r]].tolist()) for r in range(ids.shape[0])]
    B = MIX["batch"]
    assert texts == list(zip(want[:B], want[B:]))


def _refusals():
    """Each path that serves the flagship alone, called with an AV-HuBERT
    configuration or model."""
    from multimodal_av_model_tpu_torch import main as cli
    from multimodal_av_model_tpu_torch.parallel import (
        apply_fsdp,
        apply_tensor_parallel,
        make_cp_audio_encoder,
        pipeline_blocks,
    )
    from multimodal_av_model_tpu_torch.serve import AudioService
    from multimodal_av_model_tpu_torch.streaming import (
        StreamingAudioTranscriber,
        StreamingAVTranscriber,
    )
    from multimodal_av_model_tpu_torch.train.single_modality import make_audio_trainer
    from multimodal_av_model_tpu_torch.train.ssl_pretrain import MaskedAudioPretrainer

    def transcriber(cfg, model, **kw):
        return Transcriber(cfg, CharTokenizer(VOCAB), model, device="cpu", **kw)

    def contrastive_only(cfg, model, tmp):
        cfg.train.contrastive_only = True
        MultiSpeakerTrainer(cfg, model, None, device="cpu")

    def layers(model):
        x = torch.zeros(1, 4, model.config.avhubert.embed_dim)
        valid = torch.ones(1, 4, dtype=torch.bool)
        pipeline_blocks(model.encoder.layers, x, valid, valid[:, None, None], None, 1)

    return {
        "streaming_av": lambda cfg, model, tmp: StreamingAVTranscriber(
            cfg, CharTokenizer(VOCAB), model, device="cpu"),
        "streaming_audio": lambda cfg, model, tmp: StreamingAudioTranscriber(
            cfg, CharTokenizer(VOCAB), model, device="cpu"),
        "export": lambda cfg, model, tmp: export_transcriber(
            transcriber(cfg, model), str(tmp), {}),
        "int8": lambda cfg, model, tmp: transcriber(cfg, model, quantize=True),
        "service": lambda cfg, model, tmp: AudioService(transcriber(cfg, model)),
        "family_audio": lambda cfg, model, tmp: make_audio_trainer(
            cfg, CharTokenizer(VOCAB), device="cpu"),
        "family_ssl": lambda cfg, model, tmp: MaskedAudioPretrainer(cfg, device="cpu"),
        "flagship_module": lambda cfg, model, tmp: MultiSpeakerAVModel(cfg.model),
        "tp": lambda cfg, model, tmp: apply_tensor_parallel(model, None),
        "fsdp": lambda cfg, model, tmp: apply_fsdp(model, None),
        "mesh": lambda cfg, model, tmp: MultiSpeakerTrainer(cfg, model, None, device="cpu",
                                                            mesh=object()),
        "pp": lambda cfg, model, tmp: layers(model),
        "longform": lambda cfg, model, tmp: make_cp_audio_encoder(cfg.model, None),
        "contrastive_only": contrastive_only,
        "cli_stream": lambda cfg, model, tmp: cli.main(
            ["--device=cpu", "--stream=x.wav", "model.arch=avhubert"]),
    }


@pytest.mark.parametrize("path", sorted(_refusals()))
def test_paths_not_taken_refuse_it(tiny, path, tmp_path):
    cfg, model, _, _ = tiny
    cfg = tiny_config()
    with pytest.raises((ValueError, SystemExit), match="avhubert"):
        _refusals()[path](cfg, model, tmp_path)


def _counted(cfg, model, batch, train: bool):
    from torch.utils.flop_counter import FlopCounterMode

    if not train:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            _forward(model.eval(), batch)
        return counter.get_total_flops()
    trainer = MultiSpeakerTrainer(cfg, model.train(), None, device="cpu")
    state = TrainState(0, model, trainer.make_optimizer(), torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        trainer.train_step(state, batch)
    return counter.get_total_flops()


@pytest.mark.parametrize("train", [False, True], ids=["forward", "train_step"])
def test_flop_count_matches_the_flop_counter(tiny, train):
    """``avbench/flops_avhubert.py`` within 5 % of ``FlopCounterMode`` on the
    small model; exactly, once what the counter cannot see (the filterbank,
    inside K1's operator) and what it counts as dense (the grouped
    positional convolution's weight gradient, ``groups`` times the work) are
    accounted for."""
    from avbench import flops_avhubert

    cfg, _, P, raw = tiny
    model = build_av_model(cfg.model)
    model.load_state_dict(P)
    d = to_dict(cfg)["model"]
    B, T, S = MIX["batch"], MIX["bucket"], MIX["bucket"] * MIX["audio_samples_per_frame"]
    parts = flops_avhubert.forward_parts(d, B, T, S, LIP)
    counted = _counted(cfg, model, _batch(raw), train)
    if train:
        ours = flops_avhubert.train_step(d, B, T, S, LIP)
        dense_grad = parts["pos_conv"][0] * (cfg.model.avhubert.conv_pos_groups - 1)
    else:
        ours, dense_grad = flops_avhubert.forward(d, B, T, S, LIP), 0.0
    assert abs(counted - ours) <= 0.05 * ours
    assert counted == ours - parts["filterbank"][0] + dense_grad
