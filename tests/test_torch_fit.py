"""PyTorch port, the training run: ``MultiSpeakerTrainer.fit`` with the data
pipeline, checkpoints, logs and preemption.

The parity case runs both packages' ``build_data`` on one on-disk corpus in
the AI-Hub layout with ``data.device_preprocess`` on (the port's K2 runs as
its plain version on the CPU), carries one JAX ``TrainState`` into the port
(``train_state_from_jax``), and runs both ``fit``s for 2 epochs of 2 steps.
Tiny widths, f32, BatchNorm, audio dropout 0 (the libraries draw different
masks).  Tolerances:

* per-epoch train loss and eval loss: 1e-5 relative;
* WER, CER, JER (both speakers), the checkpoint files written per epoch and
  ``best.json``'s WER and patience: equal; its best loss 1e-5 relative;
* final parameters outside the visual encoder: the bar of
  ``tests/test_torch_trainer.py`` per step taken, ``2e-2 * lr * steps``, on
  the elements whose gradient was at least 1e-7 at every step (Adam moves an
  element by about lr whatever its gradient's size, so a gradient at noise
  level may take either sign);
* the visual encoder's backward at the fit's shapes and data (the first
  step's input to the encoder and the gradient that reached its output),
  both packages in f64: per tensor within 1e-6 of its norm; the port's
  first-step f32 gradients within 1e-4 of the f64 ones;
* the visual encoder's final parameters, per tensor: the update it took
  within 15 % of JAX's in norm, and its BatchNorm statistics within 1e-2 of
  their norm.  In f32 the two trajectories part here.  At 96x96 crops and
  32 frames a trunk's PReLU input can lie within rounding of 0 (at the
  first step here one lies within 1e-6); when one side's rounding puts it
  across the kink, its slope changes from alpha to 1, the gradient of the
  tensors before it moves by about 1e-2 of their norm (JAX's, at this first
  step), and Adam turns that into whole steps.  The per-element bar failed
  in the visual encoder for every corpus seed tried (0-7).  Either side
  may be the one that crosses
  (``test_visual_gradient_gap_is_rounding_at_a_discontinuity``); the f64
  case holds the backward itself.

The other cases are the port's own: early stop, a real SIGTERM mid-epoch
and the resume that redoes the epoch, asynchronous checkpoints under
in-place updates, ``save_now``, ``average_checkpoints``, ``CsvLogger``,
``TensorBoardLogger`` and ``GracefulShutdown``.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import jax
from flax import serialization

from multimodal_av_model_tpu import main as jmain
from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu.train import MultiSpeakerTrainer as JTrainer
from multimodal_av_model_tpu.train.logging_utils import CsvLogger as JCsvLogger
from multimodal_av_model_tpu.train.preempt import GracefulShutdown as JGracefulShutdown
from multimodal_av_model_tpu_torch import main as pmain
from multimodal_av_model_tpu_torch.compat import from_jax_variables, train_state_from_jax
from multimodal_av_model_tpu_torch.data.manifest import (
    build_data_list,
    speaker_id_of,
    train_val_test_split,
)
from multimodal_av_model_tpu_torch.data.pipeline import PrefetchingLoader
from multimodal_av_model_tpu_torch.data.synth_corpus import write_synthetic_corpus
from multimodal_av_model_tpu_torch.infer import Transcriber
from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
from multimodal_av_model_tpu_torch.text import CharTokenizer
from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer, restore_checkpoint
from multimodal_av_model_tpu_torch.train.checkpoints import (
    AsyncCheckpointer,
    CheckpointManager,
    average_checkpoints,
    save_checkpoint,
)
from multimodal_av_model_tpu_torch.train.logging_utils import CsvLogger, TensorBoardLogger
from multimodal_av_model_tpu_torch.train.preempt import GracefulShutdown
from test_models import tiny_config
from test_torch_models import port_config, to_np
from test_trainer import tiny_batch

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
LR = 1e-4
CKPT_FILES = ("last.ckpt", "best_wer.ckpt", "best_loss.ckpt", "best.json")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models here run many small ops, which torch's thread pool
    slows down when the suite's workers already share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = tiny_config()
    cfg.model.decoder.vocab_size = 800
    cfg.model.visual.norm = "batch"
    cfg.model.audio.dropout = 0.0
    cfg.train.log_every = 1000
    return cfg


def write_corpus(root):
    """5 speakers x 7 sentences of 0.6-1.0 s (bucket 32); with data.seed 42
    the val split holds two sentences of two speakers, as the fixed eval
    pairs need."""
    dirs = write_synthetic_corpus(root, CharTokenizer(VOCAB), n_videos=5, sentences_per_video=7,
                                  sentence_dur=(0.6, 1.0), seed=0)
    entries, _ = build_data_list(dirs["json_folder"], dirs["npy_dir"], dirs["text_dir"],
                                 dirs["wav_dir"])
    _, val, _ = train_val_test_split(entries, seed=42)
    assert len({speaker_id_of(e.text_path) for e in val}) == 2
    return dirs


def _files(directory):
    """(inode, mtime) of each checkpoint file: a rewrite replaces the inode."""
    out = {}
    for name in CKPT_FILES:
        p = os.path.join(directory, name)
        if os.path.exists(p):
            st = os.stat(p)
            out[name] = (st.st_ino, st.st_mtime_ns)
    return out


class _Recorder:
    """Wraps a trainer's ``train_epoch`` and ``evaluate``: their results, and
    before each epoch the checkpoint files as they stand."""

    def __init__(self, trainer, directory):
        self.train, self.eval, self.files = [], [], []
        epoch, evaluate = trainer.train_epoch, trainer.evaluate

        def train_epoch(*args, **kwargs):
            self.files.append(_files(directory))
            out = epoch(*args, **kwargs)
            self.train.append(float(out[1]))
            return out

        def evaluate_(*args, **kwargs):
            out = evaluate(*args, **kwargs)
            self.eval.append((float(out[0]), float(out[1]), float(out[2]),
                              {k: float(v) for k, v in out[3].items()}))
            return out

        trainer.train_epoch, trainer.evaluate = train_epoch, evaluate_
        self.directory = directory

    def written(self):
        """Per epoch, the checkpoint files written during it."""
        snaps = self.files + [_files(self.directory)]
        return [sorted(k for k, v in b.items() if a.get(k) != v)
                for a, b in zip(snaps, snaps[1:])]


@pytest.fixture(scope="module")
def fit_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    dirs = write_corpus(str(root / "corpus"))
    jcfg = _cfg()
    for k, v in dirs.items():
        setattr(jcfg.data, k, v)
    jcfg.data.video_buckets = (32,)
    jcfg.data.num_pairs_per_epoch, jcfg.data.eval_pairs = 4, 2
    jcfg.train.batch_size = jcfg.train.eval_batch_size = 2
    jcfg.train.max_epochs = 2
    jcfg.train.checkpoint_dir = str(root / "jax")
    jtok = JTokenizer(VOCAB)
    jt = JTrainer(jcfg, JModel(jcfg.model), jtok)
    j_train, j_val = jmain.build_data(jcfg, jtok, False, device_put=False)
    # The fixed eval pairs give the example batch: drawing one from the
    # train factory would advance its sampler.
    jstate = jt.init_state(0, next(iter(j_val())))
    sd0 = serialization.to_state_dict(jax.device_get(jstate))
    j_rec = _Recorder(jt, jcfg.train.checkpoint_dir)
    j_lines = []
    jstate = jt.fit(jstate, j_train, j_val, log_fn=j_lines.append)

    pcfg = port_config(jcfg)
    pcfg.train.checkpoint_dir = str(root / "port")
    trainer = MultiSpeakerTrainer(pcfg, MultiSpeakerAVModel(pcfg.model), CharTokenizer(VOCAB),
                                  device="cpu")
    state = trainer.init_state(0)
    state.load_state_dict(train_state_from_jax(sd0))
    min_grad, seen = {}, {}
    step = trainer.train_step

    def recording_step(state, batch):
        out = step(state, batch)
        if "grads" not in seen:
            seen["grads"] = {n.removeprefix("visual_encoder."): p.grad.double().clone()
                             for n, p in state.model.named_parameters()
                             if n.startswith("visual_encoder.")}
        for n, p in state.model.named_parameters():
            g = p.grad.abs()
            min_grad[n] = g if n not in min_grad else torch.minimum(min_grad[n], g)
        return out

    trainer.train_step = recording_step

    def cotangent(grad):
        seen["cotangent"] = grad.detach().numpy().copy()

    def first_visual(module, args, out):
        handle.remove()
        seen["lips"] = args[0].detach().numpy().copy()
        out.register_hook(cotangent)

    handle = state.model.visual_encoder.register_forward_hook(first_visual)
    p_rec = _Recorder(trainer, pcfg.train.checkpoint_dir)
    p_train, p_val = pmain.build_data(pcfg, CharTokenizer(VOCAB), False, device="cpu")
    p_lines = []
    state = trainer.fit(state, p_train, p_val, log_fn=p_lines.append)
    return {"jax": (j_rec, j_lines, jstate, jcfg), "port": (p_rec, p_lines, state, pcfg),
            "min_grad": min_grad, "sd0": train_state_from_jax(sd0)["model"],
            "first_visual": seen, "visual0": {"params": sd0["params"]["visual_encoder"],
                                              "batch_stats": sd0["batch_stats"]["visual_encoder"]}}


def test_fit_matches_jax_epoch_by_epoch(fit_pair):
    (j_rec, j_lines, _, jcfg), (p_rec, p_lines, state, pcfg) = fit_pair["jax"], fit_pair["port"]
    assert len(p_rec.train) == len(j_rec.train) == 2 and state.step == 4
    np.testing.assert_allclose(p_rec.train, j_rec.train, rtol=1e-5)
    for got, want in zip(p_rec.eval, j_rec.eval):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        assert got[1:3] == want[1:3] and got[3] == want[3]
    assert p_rec.written() == j_rec.written() and p_rec.written()[0] == sorted(CKPT_FILES)
    assert [ln.split()[0:2] for ln in p_lines if ln.startswith("[epoch")] == \
        [ln.split()[0:2] for ln in j_lines if ln.startswith("[epoch")] == \
        [["[epoch", "1]"], ["[epoch", "2]"]]
    with open(os.path.join(pcfg.train.checkpoint_dir, "best.json")) as f, \
            open(os.path.join(jcfg.train.checkpoint_dir, "best.json")) as g:
        got, want = json.load(f), json.load(g)
    assert got["best_wer"] == want["best_wer"] and got["no_improve"] == want["no_improve"]
    np.testing.assert_allclose(got["best_loss"], want["best_loss"], rtol=1e-5)
    for d in (pcfg.train.checkpoint_dir, jcfg.train.checkpoint_dir):
        with open(os.path.join(d, "eval_log.csv")) as f:
            assert [row.split(",")[0] for row in f.read().split()] == ["epoch", "1", "2"]
    assert restore_checkpoint(os.path.join(pcfg.train.checkpoint_dir, "last.ckpt"))["epoch"] == 2


def test_fit_final_parameters_match_jax(fit_pair):
    _, _, jstate, _ = fit_pair["jax"]
    state = fit_pair["port"][2]
    want = from_jax_variables({"params": to_np(jstate.params),
                               "batch_stats": to_np(jstate.batch_stats)})
    initial, min_grad = fit_pair["sd0"], fit_pair["min_grad"]
    n_checked = 0
    for name, value in state.model.state_dict().items():
        if name.startswith("visual_encoder."):
            # Per tensor: the update it took, and its BatchNorm statistics.
            moved = torch.linalg.vector_norm(want[name] - initial[name])
            bar = 1e-2 * torch.linalg.vector_norm(want[name]) if "running" in name \
                else 0.15 * moved
            assert torch.linalg.vector_norm(value - want[name]) <= bar, name
            continue
        sel = min_grad[name] >= 1e-7
        n_checked += int(sel.sum())
        diff = (value - want[name])[sel].abs()
        assert diff.numel() == 0 or diff.max() <= 2e-2 * LR * state.step, name
    assert n_checked > 0.9 * sum(p.numel() for n, p in state.model.named_parameters()
                                 if not n.startswith("visual_encoder."))
    saved = restore_checkpoint(os.path.join(fit_pair["port"][3].train.checkpoint_dir,
                                            "last.ckpt"))
    for name, value in state.model.state_dict().items():
        assert torch.equal(saved["state"]["model"][name], value), name


def _visual_grads(lips, w, cfg, variables, dtype):
    """The port's visual encoder gradients of ``sum(out * w)`` in train mode,
    computed in ``dtype`` throughout (its BatchNorm too), and the inputs of
    its PReLUs."""
    from multimodal_av_model_tpu_torch.compat.from_jax import visual_encoder_from_jax
    from multimodal_av_model_tpu_torch.models import VisualEncoder
    from multimodal_av_model_tpu_torch.models.layers import PReLU

    tm = VisualEncoder(port_config(cfg).model.visual)
    tm.load_state_dict(visual_encoder_from_jax(variables), strict=True)
    tm = tm.to(dtype)
    kinks = []
    for m in tm.modules():
        if hasattr(m, "dtype"):
            m.dtype = dtype
        if isinstance(m, PReLU):
            m.register_forward_pre_hook(lambda mod, args: kinks.append(args[0].detach()))
    out = tm(torch.from_numpy(lips).to(dtype), train=True)
    (out * torch.from_numpy(w).to(dtype)).sum().backward()
    return {n: p.grad.double() for n, p in tm.named_parameters()}, kinks


def _jax_visual_grads_f64(lips, w, cfg, variables):
    """JAX's visual encoder gradients of ``sum(out * w)`` in train mode, in
    f64 (flax's BatchNorm still reduces in f32)."""
    import jax.numpy as jnp

    from multimodal_av_model_tpu.models.visual import VisualEncoder as JVisual
    from multimodal_av_model_tpu_torch.compat.from_jax import visual_encoder_from_jax

    with jax.enable_x64(True):
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jm = JVisual(cfg.model.visual, dtype=jnp.float64)
        x, wj = jnp.asarray(lips, jnp.float64), jnp.asarray(w, jnp.float64)

        def loss(params):
            out, _ = jm.apply(dict(v, params=params), x, True, mutable=["batch_stats"])
            return (out * wj).sum()

        grads = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(v["params"]))
    return {n: g.double() for n, g in visual_encoder_from_jax({"params": grads}).items()}


def test_fit_visual_backward_matches_jax_in_f64(fit_pair):
    """The visual encoder's backward at the fit's shapes and data: the input
    the port's first step gave the encoder (both speakers' crops after the
    plain K2) and the gradient that reached its output, through both
    packages in f64 from the carried state.  Bar: 1e-6 of each tensor's norm
    (flax's BatchNorm reduces in f32, which leaves about 4e-8).  The first
    step's own f32 visual gradients agree with the f64 ones within 1e-4 of
    each tensor's norm, unless rounding moved a PReLU input across 0."""
    seen, variables, cfg = fit_pair["first_visual"], fit_pair["visual0"], fit_pair["jax"][3]
    assert seen["lips"].shape[2:] == (96, 96, 1) and seen["cotangent"].any()
    want = _jax_visual_grads_f64(seen["lips"], seen["cotangent"], cfg, variables)
    got, kinks64 = _visual_grads(seen["lips"], seen["cotangent"], cfg, variables, torch.float64)
    assert got.keys() == want.keys() == seen["grads"].keys()
    for name in want:
        assert torch.linalg.vector_norm(got[name] - want[name]) <= \
            1e-6 * torch.linalg.vector_norm(want[name]), name
    gap = max(float(torch.linalg.vector_norm(seen["grads"][n] - got[n])
                    / torch.linalg.vector_norm(got[n])) for n in got)
    _, kinks32 = _visual_grads(seen["lips"], seen["cotangent"], cfg, variables, torch.float32)
    crossed = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(kinks32, kinks64))
    assert gap < 1e-4 or crossed > 0, (gap, crossed)


@pytest.mark.parametrize("seed", [1, 4])
def test_visual_gradient_gap_is_rounding_at_a_discontinuity(seed):
    """At 96x96 crops the f32 visual gradients of the two packages can differ
    by about 1e-2 of a tensor's norm.  Held against the port in f64, at least
    one side agrees within 1e-4; and where the port's f32 gradient is off, a
    PReLU input of its f32 forward lies on the other side of 0 from the f64
    one (a kink that rounding crossed, whose slope changes from alpha to 1),
    so the gap is rounding at a discontinuity, not a fault of the backward.
    Which side crosses a kink depends on the input and the build."""
    import jax.numpy as jnp

    from multimodal_av_model_tpu.models.visual import VisualEncoder as JVisual
    from multimodal_av_model_tpu_torch.compat.from_jax import visual_encoder_from_jax

    cfg = tiny_config()
    cfg.model.visual.norm, cfg.model.visual.output_dim = "batch", 20
    rng = np.random.default_rng(seed)
    lips = rng.uniform(0, 1, (2, 4, 96, 96, 1)).astype(np.float32)
    w = rng.standard_normal((2, 4, 20)).astype(np.float32)
    jm = JVisual(cfg.model.visual)
    v = to_np(jm.init(jax.random.PRNGKey(3), jnp.asarray(lips)))

    def loss(params):
        out, _ = jm.apply(dict(v, params=params), jnp.asarray(lips), True,
                          mutable=["batch_stats"])
        return (out * jnp.asarray(w)).sum()

    port, kinks32 = _visual_grads(lips, w, cfg, v, torch.float32)
    exact, kinks64 = _visual_grads(lips, w, cfg, v, torch.float64)
    grads = {"jax": visual_encoder_from_jax({"params": to_np(jax.jit(jax.grad(loss))(v["params"]))}),
             "port": port}
    gap = {side: max(float(torch.linalg.vector_norm(g[n].double() - exact[n])
                           / torch.linalg.vector_norm(exact[n])) for n in exact)
           for side, g in grads.items()}
    crossed = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(kinks32, kinks64))
    print(f"seed {seed}: largest per-tensor gap to the port in f64: {gap}; "
          f"PReLU inputs of the port whose sign rounding changed: {crossed}")
    assert min(gap.values()) < 1e-4, gap
    assert gap["port"] < 1e-4 or crossed > 0, (gap, crossed)


# -- the port's own fit cases -----------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = port_config(_cfg())
    return cfg, tiny_batch(JTokenizer(VOCAB))


def _trainer(cfg, directory, **train):
    for k, v in train.items():
        setattr(cfg.train, k, v)
    cfg.train.checkpoint_dir = str(directory)
    trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model), CharTokenizer(VOCAB),
                                  device="cpu")
    return trainer, trainer.init_state(0)


def test_fit_stops_early_after_patience(tiny, tmp_path):
    import copy

    cfg, batch = copy.deepcopy(tiny[0]), tiny[1]
    trainer, state = _trainer(cfg, tmp_path, max_epochs=6, early_stop_patience=2)
    lines = []                                  # no training steps: the eval loss stays
    trainer.fit(state, lambda: [], lambda: [batch], log_fn=lines.append)
    assert [ln.split()[1] for ln in lines if ln.startswith("[epoch")] == ["1]", "2]", "3]"]
    assert lines[-1] == "early stop after 2 epochs without improvement"
    with open(tmp_path / "best.json") as f:
        assert json.load(f)["no_improve"] == 2
    # A resume keeps the count: one more epoch without improvement stops it.
    trainer, state = _trainer(cfg, tmp_path, early_stop_patience=3)
    lines = []
    trainer.fit(state, lambda: [], lambda: [batch], log_fn=lines.append, start_epoch=4)
    assert lines[-1] == "early stop after 3 epochs without improvement"


def test_sigterm_mid_epoch_saves_the_previous_epoch_and_resume_redoes_it(tiny, tmp_path):
    import copy

    cfg, batch = copy.deepcopy(tiny[0]), tiny[1]
    trainer, state = _trainer(cfg, tmp_path, max_epochs=3)
    epochs = []

    def train_factory():
        epochs.append(len(epochs) + 1)
        yield batch
        if len(epochs) == 2:
            os.kill(os.getpid(), signal.SIGTERM)    # the flag is read before the next step
        yield batch

    prior = signal.getsignal(signal.SIGTERM)
    lines = []
    state = trainer.fit(state, train_factory, lambda: [batch], log_fn=lines.append)
    assert signal.getsignal(signal.SIGTERM) is prior
    assert any(ln.startswith("preempted:") for ln in lines), lines
    assert [ln.split()[1] for ln in lines if ln.startswith("[epoch")] == ["1]"]
    assert state.step == 3
    saved = restore_checkpoint(str(tmp_path / "last.ckpt"))
    assert saved["epoch"] == 1 and saved["state"]["step"] == 3

    trainer, fresh = _trainer(cfg, tmp_path, max_epochs=2)
    payload = restore_checkpoint(str(tmp_path / "last.ckpt"), {"state": fresh, "epoch": 0})
    lines = []
    trainer.fit(fresh, lambda: [batch, batch], lambda: [batch], log_fn=lines.append,
                start_epoch=payload["epoch"] + 1)
    assert [ln.split()[1] for ln in lines if ln.startswith("[epoch")] == ["2]"]
    assert restore_checkpoint(str(tmp_path / "last.ckpt"))["state"]["step"] == 5
    with open(tmp_path / "train_log.csv") as f:
        assert [r.split(",")[0] for r in f.read().split()] == ["epoch", "1", "2"]


def test_epoch_line_splits_the_first_batch_wait(tiny, tmp_path):
    """The ``[epoch N]`` line gives the wait for the epoch's first batch apart
    from the sum (a new prefetch worker makes the loop wait for its whole
    first batch), and the epoch's seconds.  Bars: the sleeps' lower bounds."""
    import copy

    cfg, batch = copy.deepcopy(tiny[0]), tiny[1]
    trainer, state = _trainer(cfg, tmp_path, max_epochs=1)

    def batches():
        for delay in (0.3, 0.05, 0.05):
            time.sleep(delay)
            yield batch

    lines = []
    trainer.fit(state, batches, lambda: [batch], log_fn=lines.append)
    line = next(ln for ln in lines if ln.startswith("[epoch 1]"))
    kv = dict(f.split("=", 1) for f in line.split()[2:])
    wait, first, train_s = (float(kv[k].rstrip("s"))
                            for k in ("input_wait", "first_batch_wait", "train_s"))
    assert first >= 0.3 and wait - first >= 0.1 and train_s > wait, line


def test_fit_returns_promptly_when_stopped_with_a_prefetching_loader(tiny, tmp_path):
    """The consumer stops reading mid-epoch; the loader's worker, blocked on
    its full queue, ends instead of lingering."""
    import copy

    cfg, batch = copy.deepcopy(tiny[0]), tiny[1]
    trainer, state = _trainer(cfg, tmp_path, max_epochs=1)

    def batches():
        for i in range(1000):
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    before = {t.ident for t in threading.enumerate()}
    t0 = time.perf_counter()
    trainer.fit(state, lambda: PrefetchingLoader(batches, depth=2), lambda: [batch],
                log_fn=lambda s: None)
    assert time.perf_counter() - t0 < 30
    assert restore_checkpoint(str(tmp_path / "last.ckpt"))["epoch"] == 0
    deadline = time.time() + 5
    while time.time() < deadline and any(t.name == "prefetch" and t.ident not in before
                                         for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "prefetch" and t.ident not in before for t in threading.enumerate())


# -- checkpoints ------------------------------------------------------------------

def test_async_checkpoint_holds_the_values_from_before_an_in_place_update(tiny, tmp_path,
                                                                          monkeypatch):
    import copy

    from multimodal_av_model_tpu_torch.train import checkpoints

    cfg, batch = copy.deepcopy(tiny[0]), tiny[1]
    trainer, state = _trainer(cfg, tmp_path)
    state, _ = trainer.train_step(state, batch)
    before = {k: v.clone() for k, v in state.state_dict()["model"].items()}
    mu_before = {k: v.clone() for k, v in state.optimizer.state_dict()["mu"].items()}
    # The writer thread serialises only after the updates below.
    updated, write = threading.Event(), checkpoints._write_files
    monkeypatch.setattr(checkpoints, "_write_files",
                        lambda snapshot, paths: updated.wait(30) and write(snapshot, paths))
    writer = AsyncCheckpointer()
    writer.save({"state": state, "epoch": 1}, [str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")])
    with torch.no_grad():                       # in place, as the next step does
        for p in state.model.parameters():
            p.add_(1.0)
    state, _ = trainer.train_step(state, batch)
    updated.set()
    writer.close()
    save_checkpoint(str(tmp_path / "now.ckpt"), {"state": state, "epoch": 2})
    for name in ("a.ckpt", "b.ckpt"):
        saved = restore_checkpoint(str(tmp_path / name))
        assert saved["epoch"] == 1 and saved["state"]["step"] == 1
        for k, v in before.items():
            assert torch.equal(saved["state"]["model"][k], v), k
        for k, v in mu_before.items():
            assert torch.equal(saved["state"]["optimizer"]["mu"][k], v), k
    now = restore_checkpoint(str(tmp_path / "now.ckpt"))["state"]["model"]
    assert not torch.equal(now["decoder.head.weight"], before["decoder.head.weight"])


def test_async_manager_matches_sync_and_save_now_drains_the_queue(tmp_path):
    history = [(3.0, 0.9), (2.0, 0.95), (2.5, 0.8)]
    managers = {m: CheckpointManager(str(tmp_path / m), async_io=(m == "async"))
                for m in ("sync", "async")}
    w = torch.arange(6, dtype=torch.float32)
    for i, (loss, wer) in enumerate(history):
        w += 1
        for m in managers.values():
            m.on_epoch_end({"state": {"w": w}, "epoch": i + 1}, loss, wer)
    managers["async"].save_now({"state": {"w": w * 10}, "epoch": 7})
    assert managers["async"]._async._q.unfinished_tasks == 0
    managers["sync"].save_now({"state": {"w": w * 10}, "epoch": 7})
    for name in CKPT_FILES[:3]:
        a = restore_checkpoint(str(tmp_path / "sync" / name))
        b = restore_checkpoint(str(tmp_path / "async" / name))
        assert a["epoch"] == b["epoch"] and torch.equal(a["state"]["w"], b["state"]["w"])
    assert restore_checkpoint(str(tmp_path / "async" / "last.ckpt"))["epoch"] == 7
    assert restore_checkpoint(str(tmp_path / "async" / "best_wer.ckpt"))["epoch"] == 3
    assert restore_checkpoint(str(tmp_path / "async" / "best_loss.ckpt"))["epoch"] == 2
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    writer = AsyncCheckpointer()
    writer.save({"x": w}, [str(blocker / "c.ckpt")])
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.wait()
    sharded = CheckpointManager(str(tmp_path / "s"), layout="sharded")
    sharded.save_now({"state": {"w": w * 10}, "epoch": 7})
    back = sharded.try_resume({"state": {"w": torch.zeros_like(w)}, "epoch": 0})
    assert back["epoch"] == 7 and torch.equal(back["state"]["w"], w * 10)
    with pytest.raises(ValueError, match="unknown checkpoint layout"):
        CheckpointManager(str(tmp_path / "t"), layout="bogus")


def test_average_checkpoints_and_a_transcriber_of_their_average(tiny, tmp_path):
    import copy

    cfg, batch = copy.deepcopy(tiny[0]), tiny[1]
    trainer, state = _trainer(cfg, tmp_path)
    paths = []
    for i in range(3):
        state, _ = trainer.train_step(state, batch)
        paths.append(str(tmp_path / f"e{i}.ckpt"))
        save_checkpoint(paths[-1], {"state": state, "epoch": i})
    models = [restore_checkpoint(p)["state"]["model"] for p in paths]
    avg = average_checkpoints(paths)
    assert avg["epoch"] == 0 and avg["state"]["step"] == 1
    for k, v in avg["state"]["model"].items():
        want = sum(m[k].double() for m in models) / 3
        torch.testing.assert_close(v, want.float(), rtol=0, atol=1e-7, msg=k)
    ints = [str(tmp_path / "i0.ckpt"), str(tmp_path / "i1.ckpt")]
    save_checkpoint(ints[0], {"state": {"model": {"n": torch.tensor([1, 2]),
                                                  "w": torch.tensor([1.0, 2.0])}}})
    save_checkpoint(ints[1], {"state": {"model": {"n": torch.tensor([5, 6]),
                                                  "w": torch.tensor([3.0, 6.0])}}})
    mixed = average_checkpoints(ints)["state"]["model"]
    assert torch.equal(mixed["n"], torch.tensor([1, 2]))
    assert torch.equal(mixed["w"], torch.tensor([2.0, 4.0]))
    with pytest.raises(ValueError):
        average_checkpoints([])

    soup = Transcriber.from_checkpoint(cfg, CharTokenizer(VOCAB), paths, device="cpu")
    single = Transcriber.from_checkpoint(cfg, CharTokenizer(VOCAB), paths[0], device="cpu")
    for k, v in soup.model.state_dict().items():
        assert torch.equal(v, avg["state"]["model"][k]), k
    assert torch.equal(single.model.decoder.head.weight, models[0]["decoder.head.weight"])
    texts = soup.transcribe(batch)
    assert len(texts) == batch["audio"].shape[0] and all(len(t) == 2 for t in texts)


# -- logs and signals --------------------------------------------------------------

def test_csv_logger_matches_jax_and_appends_on_resume(tmp_path):
    for name, cls in (("ours", CsvLogger), ("theirs", JCsvLogger)):
        path = str(tmp_path / name / "log.csv")
        log = cls(path, ["epoch", "loss"])
        log.log(epoch=1, loss="2.5000")
        log.close()
        log = cls(path, ["epoch", "loss"], resume=True)
        log.log(epoch=2, loss="2.0000")
        log.close()
    with open(tmp_path / "ours" / "log.csv") as f, open(tmp_path / "theirs" / "log.csv") as g:
        got = f.read()
        assert got == g.read() and got.split() == ["epoch,loss", "1,2.5000", "2,2.0000"]
    log = CsvLogger(str(tmp_path / "ours" / "log.csv"), ["epoch", "loss"])
    log.close()                                 # a fresh run truncates
    with open(tmp_path / "ours" / "log.csv") as f:
        assert f.read().split() == ["epoch,loss"]


def test_tensorboard_logger_writes_scalars_or_nothing(tmp_path):
    assert not TensorBoardLogger("").active
    TensorBoardLogger("").scalars(1, loss=1.0)
    tb = TensorBoardLogger(str(tmp_path / "tb"))
    tb.scalars(1, loss=1.0, bad="not a number")
    tb.close()
    try:
        import tensorboardX  # noqa: F401
    except ImportError:
        assert not tb.active
    else:
        assert tb.active and any(n.startswith("events") for n in os.listdir(tmp_path / "tb"))


@pytest.mark.parametrize("cls", [GracefulShutdown, JGracefulShutdown])
def test_graceful_shutdown_restores_handlers_and_is_inert_when_disabled(cls):
    prior = signal.getsignal(signal.SIGTERM)
    with cls() as stop:
        assert not stop.requested and signal.getsignal(signal.SIGTERM) is not prior
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.requested
    assert signal.getsignal(signal.SIGTERM) is prior
    prior_int = signal.getsignal(signal.SIGINT)
    with cls(enable=False) as stop:
        assert signal.getsignal(signal.SIGINT) is prior_int
        stop.request()
        assert stop.requested
    done = []
    threading.Thread(target=lambda: done.append(cls().__enter__().requested)).start()
    deadline = time.time() + 5
    while not done and time.time() < deadline:
        time.sleep(0.01)
    assert done == [False] and signal.getsignal(signal.SIGTERM) is prior
