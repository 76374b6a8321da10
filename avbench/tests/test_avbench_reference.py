"""The plain reference against the system at a tiny float32 size on the CPU:
the forward's log-probabilities and lengths, three training steps, the
prefix beam search."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from avbench import harness, traffic, weights
from avbench.reference import decode as ref_decode
from avbench.reference import preprocess as ref_pre
from avbench.reference.model import Net
from avbench.runners import common
from avbench.runners import train as train_runner
from avbench.tests.tiny import tiny_cell


@pytest.mark.parametrize("name", ["av_flagship.transcribe_b4", "av_flagship_tf.transcribe_b4"])
def test_forward_matches_the_system(name):
    from multimodal_av_model_tpu_torch.data.device_pipeline import preprocess_batch_device

    torch.set_num_threads(2)
    cell = tiny_cell(name)
    ctx = harness.make_context(cell, 2**31 + 9, "cpu")
    model, template = common.seeded_model(ctx)
    raw = traffic.raw_batches(cell.mix, 4)[0]
    b = preprocess_batch_device(raw["lip1_raw"], raw["lip2_raw"], raw["audio1"], raw["audio2"],
                                raw["audio1_len"], raw["audio2_len"],
                                out_size=cell.mix["lip_size"], device="cpu")
    with torch.no_grad():
        out = model.eval()(b["lip1"], b["lip2"], b["audio"], b["mask1"], b["mask2"],
                           torch.from_numpy(raw["lip1_lengths"]),
                           torch.from_numpy(raw["lip2_lengths"]))
        net = Net(weights.seeded_state_dict(template, ctx.seed, "cpu"), ctx.model)
        inp = ref_pre.model_inputs(raw, "cpu", cell.mix["lip_size"])
        ref = net.forward(inp, ref_pre.log_mel(inp["audio"], ctx.model["frontend"]))
    lp = torch.cat([out["log_probs1"], out["log_probs2"]])
    assert torch.equal(torch.cat([out["input_lengths1"], out["input_lengths2"]]).long(),
                       ref["input_lengths"].long())
    assert (lp - ref["log_probs"]).abs().max() < 1e-4


def test_three_training_steps_match_the_system():
    torch.set_num_threads(2)
    cell = tiny_cell("av_flagship.train_b8")
    ctx = harness.make_context(cell, 17, "cpu")
    job = train_runner.Job(ctx)
    job.warm_up()
    ref = train_runner.reference_steps(ctx, job.template, job.pool, cell.mix["check_steps"])
    gaps = train_runner.compare(job.program, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-3 and gaps["update_gap"] < 1e-3
    assert gaps["grad_diff"] < 1e-3


def test_prefix_beam_matches_the_system():
    from multimodal_av_model_tpu_torch.ops.prefix_beam_search import prefix_beam_search_decode

    g = torch.Generator().manual_seed(0)
    lp = torch.log_softmax(3 * torch.randn(6, 40, 12, generator=g), -1)
    lengths = torch.tensor([40, 33, 1, 0, 20, 39])
    ids, n, _ = prefix_beam_search_decode(lp, lengths, 5, 8, 3)
    for r in range(6):
        want = ref_decode.prefix_beam(lp[r].numpy(), int(lengths[r]), 5, 8, 3)
        assert ids[r, : n[r]].tolist() == want


def test_lip_resize_and_log_mel_match_the_plain_kernels():
    from multimodal_av_model_tpu_torch.ops.logmel import log_mel_spectrogram
    from multimodal_av_model_tpu_torch.ops.resize import lip_frames_preprocess

    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8))
    got = ref_pre.lips(frames[None], 96)[0]
    assert (got - lip_frames_preprocess(frames, 96)).abs().max() < 1e-5
    wave = torch.from_numpy(rng.standard_normal((2, 8000)).astype(np.float32))
    fe = {"sample_rate": 16000, "n_fft": 400, "hop_length": 160, "win_length": 400,
          "n_mels": 80, "f_min": 0.0, "f_max": None, "log_eps": 1e-6, "center": True}
    assert (ref_pre.log_mel(wave, fe) - log_mel_spectrogram(wave)).abs().max() < 1e-3
