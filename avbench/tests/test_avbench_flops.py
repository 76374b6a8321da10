"""``avbench/flops.py`` against ``FlopCounterMode`` on the system's model at a
tiny float32 size on the CPU.

``FlopCounterMode`` sees neither the mel filterbank (inside the log-mel
operator) nor recomputation's absence: it counts what runs.  It also counts
a depthwise convolution's weight gradient as if the convolution were dense
(``groups`` ignored), ``d_model`` times the true work.  With those three
accounted for, the counts agree exactly."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from avbench import flops, harness
from avbench.runners import common
from avbench.runners import train as train_runner
from avbench.tests.tiny import tiny_cell


def _job(name):
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    ctx = harness.make_context(cell, 3, "cpu")
    return cell, ctx, train_runner.Job(ctx)


@pytest.mark.parametrize("name", ["av_flagship.train_b8", "av_flagship_tf.train_b32"])
def test_forward_matches_flop_counter(name):
    from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches

    cell, ctx, job = _job(name)
    raw = job.pool[0]
    (batch,) = device_preprocessed_batches([raw], out_size=cell.mix["lip_size"], device="cpu")
    model = job.state.model.eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(batch["lip1"], batch["lip2"], batch["audio"], batch["mask1"], batch["mask2"],
              torch.from_numpy(raw["lip1_lengths"]), torch.from_numpy(raw["lip2_lengths"]))
    B, T, S = common.shapes(cell.mix)
    parts = flops.forward_parts(ctx.model, B, T, S, cell.mix["lip_size"])
    assert counter.get_total_flops() == flops.forward(ctx.model, B, T, S, cell.mix["lip_size"]) \
        - parts["mel_filterbank"][0]


@pytest.mark.parametrize("name", ["av_flagship.train_b8", "av_flagship_tf.train_b32"])
def test_train_step_matches_flop_counter(name):
    cell, ctx, job = _job(name)
    with FlopCounterMode(display=False) as counter:
        job.unit(0)
    B, T, S = common.shapes(cell.mix)
    lip = cell.mix["lip_size"]
    parts = flops.forward_parts(ctx.model, B, T, S, lip)
    a = ctx.model["audio"]
    _, T_enc = flops.audio_frames(ctx.model, S)
    dense_depthwise = (a["num_layers"] * 2.0 * B * a["d_model"] * a["conv_kernel_size"] * T_enc
                       * (a["d_model"] - 1))
    recompute = parts["visual_frontend"][0] if cell.mix["settings"][
        "model.visual.remat"] == "frontend" else 0.0
    expected = (flops.train_step(ctx.model, B, T, S, lip) - parts["mel_filterbank"][0]
                + dense_depthwise + recompute)
    assert counter.get_total_flops() == expected


@pytest.mark.gpu
def test_flagship_step_count_on_the_card():
    """The B = 8 flagship step (remat none) at full size on the card: the same
    three differences from ``FlopCounterMode``, and the ratio printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell.find("av_flagship.train_b8")
    ctx = harness.make_context(cell, 11, "cuda")
    job = train_runner.Job(ctx)
    job.unit(0)
    with FlopCounterMode(display=False) as counter:
        job.unit(1)
        torch.cuda.synchronize()
    B, T, S = common.shapes(cell.mix)
    parts = flops.forward_parts(ctx.model, B, T, S, cell.mix["lip_size"])
    a = ctx.model["audio"]
    _, T_enc = flops.audio_frames(ctx.model, S)
    dense_depthwise = (a["num_layers"] * 2.0 * B * a["d_model"] * a["conv_kernel_size"] * T_enc
                       * (a["d_model"] - 1))
    ours = flops.train_step(ctx.model, B, T, S, cell.mix["lip_size"])
    print(f"flops.py {ours / 1e12:.4f} TFLOP, FlopCounterMode "
          f"{counter.get_total_flops() / 1e12:.4f} TFLOP, ratio "
          f"{counter.get_total_flops() / ours:.4f}")
    assert counter.get_total_flops() == ours - parts["mel_filterbank"][0] + dense_depthwise
