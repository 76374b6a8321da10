"""Hooks of the port that mirror ``__graft_entry__.py``: a forward at full
width on the card, and one training step over a DP x TP x FSDP mesh of gloo
processes on the CPU, held against the same step in one process.

* ``entry()`` -> ``(fn, example_args)``: the flagship forward at the shipped
  widths with ``visual.norm="group"`` (``__graft_entry__.py:16-85``), bf16
  compute, example arguments on the card (``device="cpu"`` for the CPU);
* ``dryrun_multichip(n)``: the tiny flagship (``__graft_entry__.py:16-45``:
  BatchNorm, transformer temporal model) at ``(n / 2, 2)`` (DP x TP) with
  FSDP over ``n`` gloo processes, one step on an ``n``-row batch, its loss
  and ``grad_norm`` checked against the one-process step
  (``__graft_entry__.py:149-219``); then, for every ``n >= 4``, the
  pipeline leg (``:241-297``) on ``4 (n // 4)`` gloo processes of a second
  spawn, as JAX runs it on the first ``4 (n // 4)`` devices: 4 seeded
  Conformer blocks of width 16 over a ``(n // 4 data, 4 pipe)`` mesh,
  4 x data rows of 8 frames in 2 microbatches, the pipelined forward against
  the blocks applied in turn (below 2e-5) and one SGD step through the
  pipeline with a finite loss (``parallel/spawn.py:pipeline_leg``).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                     "tokenizer800.vocab")


def flagship_config(tiny: bool = False):
    """``__graft_entry__.py:16-45``'s configuration."""
    from .config import Config

    cfg = Config()
    if tiny:
        a, v, f = cfg.model.audio, cfg.model.visual, cfg.model.fusion
        a.d_model, a.num_layers, a.num_heads, a.ffn_dim = 32, 2, 2, 64
        a.conv_kernel_size, a.middle_layers, a.output_dim = 7, (0, 1), 48
        v.frontend_channels, v.resnet_layers = 8, (1, 1, 1, 1)
        v.resnet_channels, v.output_dim, v.norm = (8, 12, 16, 24), 24, "batch"
        f.fused_dim, f.num_heads, f.temporal_model = 16, 2, "transformer"
        cfg.model.contrastive.projection_dim = 8
        cfg.model.decoder.vocab_size = 50
    else:
        cfg.model.visual.norm = "group"
    return cfg


def example_batch(rng, B: int, T_v: int, S: int, lip: int = 96):
    """``__graft_entry__.py:48-56``: ``(lip1, lip2, audio, mask1, mask2,
    len1, len2)`` as numpy."""
    lip1 = rng.uniform(size=(B, T_v, 1, lip, lip)).astype(np.float32)
    lip2 = rng.uniform(size=(B, T_v, 1, lip, lip)).astype(np.float32)
    audio = rng.standard_normal((B, S)).astype(np.float32) * 0.1
    mask1 = rng.integers(0, 3, size=(B, S)).astype(np.int32)
    mask2 = rng.integers(0, 3, size=(B, S)).astype(np.int32)
    lens = np.full((B,), T_v, np.int32)
    return lip1, lip2, audio, mask1, mask2, lens, lens


def train_batch(rng, B: int, vocab_size: int, T_v: int = 4, S: int = 2136, lip: int = 24,
                label_len: int = 2) -> dict:
    """``dryrun_multichip``'s batch (``__graft_entry__.py:183-199``)."""
    lip1, lip2, audio, mask1, mask2, l1, l2 = example_batch(rng, B, T_v, S, lip)
    return {
        "lip1": lip1, "lip2": lip2, "audio": audio, "mask1": mask1, "mask2": mask2,
        "lip1_lengths": l1, "lip2_lengths": l2,
        "audio_lengths": np.full((B,), S, np.int32),
        "text1": rng.integers(5, vocab_size, size=(B, label_len)).astype(np.int32),
        "text1_lengths": np.full((B,), label_len, np.int32),
        "text2": rng.integers(5, vocab_size, size=(B, label_len)).astype(np.int32),
        "text2_lengths": np.full((B,), label_len, np.int32),
    }


def entry(device: str = "cuda"):
    """``(fn, example_args)``: the flagship eval forward at full width (bf16
    compute, group norm) and example arguments on ``device``; ``fn`` returns
    ``(log_probs1, log_probs2, input_lengths1)``."""
    import torch

    from .models import MultiSpeakerAVModel
    from .models.layers import init_weights

    cfg = flagship_config()
    model = MultiSpeakerAVModel(cfg.model, torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    B, T_v = 2, 16
    args = tuple(torch.from_numpy(a).to(device)
                 for a in example_batch(np.random.default_rng(0), B, T_v, T_v * 534))

    @torch.no_grad()
    def fn(lip1, lip2, audio, mask1, mask2, len1, len2):
        out = model(lip1, lip2, audio, mask1, mask2, len1, len2)
        return out["log_probs1"], out["log_probs2"], out["input_lengths1"]

    return fn, args


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> dict:
    """One DP x TP x FSDP training step of the tiny flagship over
    ``n_devices`` gloo processes, checked against the one-process step on
    the same batch, and for ``n_devices >= 4`` the pipeline leg over
    ``4 (n_devices // 4)`` more -> ``{"loss", "loss_diff",
    "grad_norm_diff"}`` (and ``"pp_diff", "pp_loss"``)."""
    import torch

    from .models import MultiSpeakerAVModel
    from .parallel.spawn import meshed_train_steps, pipeline_leg, run_ranks
    from .text import CharTokenizer
    from .train import MultiSpeakerTrainer

    tok = CharTokenizer(VOCAB)
    cfg = flagship_config(tiny=True)
    cfg.model.decoder.vocab_size = tok.vocab_size
    model_parallel = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    batch = train_batch(np.random.default_rng(0), n_devices, tok.vocab_size)
    with tempfile.TemporaryDirectory(prefix="mmav-dryrun-") as work:
        out = os.path.join(work, "result.pt")
        run_ranks(meshed_train_steps, n_devices, work,
                  ([{"out": out, "cfg": cfg, "model_parallel": model_parallel, "fsdp": True,
                     "steps": 1}], VOCAB, batch), timeout=timeout)
        meshed = torch.load(out, weights_only=True)["metrics"][0]
        pp = None
        if n_devices >= 4:
            pp_out = os.path.join(work, "pp.pt")
            run_ranks(pipeline_leg, 4 * (n_devices // 4), work, (pp_out,), timeout=timeout)
            pp = torch.load(pp_out, weights_only=True)

    trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model), tok, device="cpu")
    _, one = trainer.train_step(trainer.init_state(0), batch)
    loss, gnorm = meshed["loss"], meshed["grad_norm"]
    loss_diff = abs(loss - float(one["loss"]))
    gnorm_diff = abs(gnorm - float(one["grad_norm"]))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if loss_diff >= 1e-4:
        raise AssertionError(f"sharded != single-device loss (|diff| {loss_diff:.3e})")
    if gnorm_diff >= 1e-3 * max(gnorm, 1.0):
        raise AssertionError(f"sharded != single-device grad_norm (|diff| {gnorm_diff:.3e})")
    print(f"dryrun_multichip({n_devices}): loss={loss:.4f} "
          f"sharded-vs-1dev |loss diff|={loss_diff:.3e} |grad_norm diff|={gnorm_diff:.3e} OK")
    report = {"loss": loss, "loss_diff": loss_diff, "grad_norm_diff": gnorm_diff}
    if pp is None:
        return report
    if pp["pp_diff"] >= 2e-5:
        raise AssertionError(f"pipelined != sequential (max abs diff {pp['pp_diff']:.3e})")
    if not np.isfinite(pp["pp_loss"]):
        raise AssertionError(f"non-finite PP loss {pp['pp_loss']}")
    print(f"dryrun_multichip({n_devices}): PP ({n_devices // 4} data x 4 pipe) "
          f"loss={pp['pp_loss']:.4f} pipelined-vs-sequential max|diff|={pp['pp_diff']:.3e} OK")
    return {**report, **pp}


if __name__ == "__main__":
    dryrun_multichip(4)
