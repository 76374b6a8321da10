"""PyTorch port, sharded checkpoints (``train/sharded_checkpoints.py``,
``torch.distributed.checkpoint``): a save under FSDP x TP on four gloo
processes restored under DP4 and into one process, and a one-process save
restored under FSDP x TP, tensors equal; the
``COMMITTED`` marker; bf16 leaves; the manager's rolling policy and
``save_now`` in the sharded layout; and the CLI under ``torchrun
--nproc-per-node=2`` (gloo, ``--device=cpu``, tiny widths): one epoch, then
a resume.  Restored tensors are compared exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodal_av_model_tpu_torch import graft_entry
from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
from multimodal_av_model_tpu_torch.parallel.spawn import meshed_train_steps, run_ranks
from multimodal_av_model_tpu_torch.text import CharTokenizer
from multimodal_av_model_tpu_torch.train import CheckpointManager, MultiSpeakerTrainer
from multimodal_av_model_tpu_torch.train.checkpoints import host_snapshot
from multimodal_av_model_tpu_torch.train.sharded_checkpoints import (
    MARKER,
    restore_sharded,
    save_sharded,
    sharded_checkpoint_exists,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = graft_entry.flagship_config(tiny=True)
    cfg.model.decoder.vocab_size = 800
    return cfg


def _equal(a: dict, b: dict, what: str):
    assert set(a) == set(b), what
    for k in a:
        if isinstance(a[k], dict):
            _equal(a[k], b[k], f"{what}.{k}")
        elif isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), f"{what}.{k}"
        else:
            assert a[k] == b[k], f"{what}.{k}"


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """Two steps at DP2 x TP2 x FSDP saved sharded, then restored at DP4 in
    the same four-process group; and a one-process save restored at DP2 x
    TP2 x FSDP there."""
    work = tmp_path_factory.mktemp("ckpt")
    ckpt, plain_ckpt = str(work / "sharded"), str(work / "plain")
    saved, restored, into_fsdp = (str(work / f) for f in ("saved.pt", "restored.pt", "into.pt"))
    batch = graft_entry.train_batch(np.random.default_rng(0), 4, 800)
    cfg = _cfg()
    trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model),
                                  CharTokenizer(graft_entry.VOCAB), device="cpu")
    state, _ = trainer.train_step(trainer.init_state(3), batch)
    save_sharded(plain_ckpt, {"state": state, "epoch": 5})
    run_ranks(meshed_train_steps, 4, str(work),
              ([{"out": saved, "cfg": _cfg(), "model_parallel": 2, "fsdp": True, "steps": 2,
                 "save_to": ckpt},
                {"out": restored, "cfg": _cfg(), "restore_from": ckpt},
                {"out": into_fsdp, "cfg": _cfg(), "model_parallel": 2, "fsdp": True,
                 "restore_from": plain_ckpt}],
               graft_entry.VOCAB, batch), timeout=240)
    return (ckpt, torch.load(saved, weights_only=True), torch.load(restored, weights_only=True),
            host_snapshot(state), torch.load(into_fsdp, weights_only=True))


def test_a_fsdp_tp_checkpoint_restores_under_dp4(round_trip):
    ckpt, saved, restored = round_trip[:3]
    assert saved["mesh"] == (2, 2) and restored["mesh"] == (4, 1)
    assert sharded_checkpoint_exists(ckpt)
    assert len([f for f in os.listdir(ckpt) if f.endswith(".distcp")]) == 4
    _equal(restored["state"], saved["state"], "state")
    assert saved["state"]["step"] == 2 and saved["state"]["optimizer"]["updates"] == 2


def test_a_fsdp_tp_checkpoint_restores_into_one_process(round_trip):
    ckpt, saved = round_trip[:2]
    cfg = _cfg()
    trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model),
                                  CharTokenizer(graft_entry.VOCAB), device="cpu")
    state = trainer.init_state(1)
    back = restore_sharded(ckpt, {"state": state, "epoch": 0})
    assert back["epoch"] == 2 and back["state"] is state
    _equal(host_snapshot(state), saved["state"], "state")


def test_a_one_process_checkpoint_restores_under_fsdp_tp(round_trip):
    one, into = round_trip[3], round_trip[4]
    assert into["mesh"] == (2, 2)
    _equal(into["state"], one, "state")
    assert one["optimizer"]["updates"] == 1


def test_an_uncommitted_save_is_not_restorable(tmp_path):
    tree = {"w": torch.arange(6.0), "n": 3}
    save_sharded(str(tmp_path / "ok"), tree)
    assert sharded_checkpoint_exists(str(tmp_path / "ok"))
    assert not os.path.exists(str(tmp_path / "ok") + ".tmp")
    os.unlink(tmp_path / "ok" / MARKER)          # as if the save had crashed before the marker
    assert not sharded_checkpoint_exists(str(tmp_path / "ok"))
    with pytest.raises(FileNotFoundError, match="no committed sharded checkpoint"):
        restore_sharded(str(tmp_path / "ok"), {"w": torch.zeros(6), "n": 0})
    with pytest.raises(ValueError, match="needs a template"):
        restore_sharded(str(tmp_path / "ok"), None)


def test_bf16_leaves_round_trip(tmp_path):
    w = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    save_sharded(str(tmp_path / "c"), {"w": w, "f": torch.ones(3), "epoch": 4})
    back = restore_sharded(str(tmp_path / "c"),
                           {"w": torch.zeros(5, 7, dtype=torch.bfloat16), "f": torch.zeros(3),
                            "epoch": 0})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], w)
    assert torch.equal(back["f"], torch.ones(3)) and back["epoch"] == 4


def test_the_manager_rolls_sharded_checkpoints_and_saves_now(tmp_path):
    m = CheckpointManager(str(tmp_path), layout="sharded")
    assert not m.exists() and m.try_resume({"w": torch.zeros(2), "epoch": 0}) is None
    history = [(3.0, 0.9), (2.0, 0.95), (2.5, 0.8)]
    for i, (loss, wer) in enumerate(history):
        saved = m.on_epoch_end({"w": torch.full((2,), float(i + 1)), "epoch": i + 1}, loss, wer)
        assert saved == {"last": True, "best_wer": wer < min([1.0] + [w for _, w in history[:i]]),
                         "best_loss": loss < min([9.0] + [lo for lo, _ in history[:i]])}

    def epoch_of(path):
        return restore_sharded(path, {"w": torch.zeros(2), "epoch": 0})["epoch"]

    assert (epoch_of(m.last), epoch_of(m.best_wer), epoch_of(m.best_loss)) == (3, 3, 2)
    assert all(os.path.isdir(p) for p in (m.last, m.best_wer, m.best_loss))
    m.save_now({"w": torch.full((2,), 7.0), "epoch": 7})
    back = CheckpointManager(str(tmp_path), layout="sharded").try_resume(
        {"w": torch.zeros(2), "epoch": 0})
    assert back["epoch"] == 7 and torch.equal(back["w"], torch.full((2,), 7.0))
    assert epoch_of(m.best_wer) == 3


TINY = ["model.audio.d_model=32", "model.audio.num_layers=2", "model.audio.num_heads=2",
        "model.audio.ffn_dim=64", "model.audio.conv_kernel_size=7",
        "model.audio.middle_layers=(0,1)", "model.audio.output_dim=48",
        "model.visual.frontend_channels=8", "model.visual.resnet_layers=(1,1,1,1)",
        "model.visual.resnet_channels=(8,12,16,24)", "model.visual.output_dim=24",
        "model.fusion.fused_dim=16", "model.fusion.num_heads=2",
        "model.contrastive.projection_dim=8", "model.dtype=float32", "model.visual.norm=batch",
        "data.num_pairs_per_epoch=4", "data.eval_pairs=4", "train.batch_size=4",
        "train.eval_batch_size=4", "train.log_every=100"]


def _torchrun(args, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
         "-m", "multimodal_av_model_tpu_torch.main", "--device=cpu", "--synthetic", *TINY, *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_the_cli_under_torchrun_trains_and_resumes(tmp_path):
    ckpt = tmp_path / "ckpt"
    common = [f"train.checkpoint_dir={ckpt}", "mesh.fsdp=true",
              "train.checkpoint_layout=sharded"]
    out = _torchrun(common + ["train.max_epochs=1"])
    assert out.count("process ") == 2 and "local batch 2 (train) / 2 (eval)" in out
    assert out.count("[epoch 1] train_loss=") == 2
    assert os.path.isfile(ckpt / "last.ckpt" / MARKER)
    with open(ckpt / "train_log.csv") as f:
        assert len(f.read().splitlines()) == 2         # header + one epoch, from rank 0 alone
    out = _torchrun(common + ["train.max_epochs=2"])
    assert out.count(f"resuming from {ckpt}/last.ckpt at epoch 2") == 2
    assert out.count("[epoch 2] train_loss=") == 2
