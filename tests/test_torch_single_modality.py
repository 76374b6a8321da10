"""PyTorch port, the audio-only and visual-only families:
``VisualOnlyCTC``, ``train/single_modality.py`` and the CLI's
``--family=audio|visual``, held against the JAX package on the CPU at tiny
widths, f32 (the families' dtype in both packages), BatchNorm in the visual
trunk, audio dropout 0 (the libraries draw different masks).

Tolerances:
* forwards: 1e-4 (relative and absolute);
* 1 and 3 steps from one state (carried by ``single_modality_state_from_jax``),
  the bars of ``tests/test_torch_trainer.py``: loss rtol 1e-4; each gradient
  within 1e-3 of its norm; parameters within ``2e-2 * lr`` per step taken on
  elements whose JAX gradient is at least 1e-7, and here also at least 1e-6
  of the tensor's largest (Adam moves an element by about lr whatever its
  gradient's size, and in the audio subsampler, whose gradients reach 1.3, an
  element at 4e-7 in JAX is 4e-9 in the port: f32 noise of a sum over the
  frames); BatchNorm statistics rtol 1e-4;
* the one-group optimizer against ``chain(clip_by_global_norm,
  adam(schedule))`` on fixed gradients: rtol 1e-5;
* a flush batch's loss: 1e-6 of the unpadded batch's;
* ``utterance_batches``: equal arrays, but the visual family's lips within
  1e-6 absolute (the JAX package may resize with its native host op, as in
  ``tests/test_torch_data.py``); ``evaluate``: loss rtol 1e-4, WER and CER
  equal.

The CLI cases run the port alone: the audio family trains, resumes with its
dropout generator, then ``--eval``, ``--infer`` and ``--stream`` on its
checkpoint directory; a visual-family checkpoint grafts into the flagship.
``fit`` saves the previous epoch on a real SIGTERM and raises on a
non-finite loss before writing a checkpoint.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import optax
from flax import serialization

from multimodal_av_model_tpu.data.manifest import build_data_list as j_build_data_list
from multimodal_av_model_tpu.models import VisualOnlyCTC as JVisualOnly
from multimodal_av_model_tpu.text import CharTokenizer as JTokenizer
from multimodal_av_model_tpu.train.single_modality import make_audio_trainer as j_make_audio
from multimodal_av_model_tpu.train.single_modality import make_visual_trainer as j_make_visual
from multimodal_av_model_tpu.train.single_modality import utterance_batches as j_utterances
from multimodal_av_model_tpu_torch import main as pmain
from multimodal_av_model_tpu_torch.compat import (
    audio_only_from_jax,
    single_modality_state_from_jax,
    visual_only_from_jax,
)
from multimodal_av_model_tpu_torch.data.audio_io import write_wav
from multimodal_av_model_tpu_torch.data.manifest import build_data_list
from multimodal_av_model_tpu_torch.models import VisualOnlyCTC
from multimodal_av_model_tpu_torch.text import CharTokenizer
from multimodal_av_model_tpu_torch.train import (
    GroupAdam,
    MultiSpeakerTrainer,
    SingleModalityTrainer,
    make_audio_trainer,
    make_visual_trainer,
    restore_checkpoint,
)
from multimodal_av_model_tpu_torch.train.single_modality import (
    synthetic_audio_batches,
    synthetic_visual_batches,
    utterance_batches,
)
from test_models import tiny_config
from test_torch_cli import SMALL, TINY
from test_torch_fit import write_corpus
from test_torch_models import perturb_batch_stats, port_config, to_np

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tok():
    return JTokenizer(VOCAB)


def _cfg():
    cfg = tiny_config()
    cfg.model.decoder.vocab_size = 800
    cfg.model.visual.norm = "batch"
    cfg.model.audio.dropout = 0.0
    cfg.train.learning_rate = LR
    return cfg


def _batches(family, tok):
    if family == "audio":
        return list(synthetic_audio_batches(tok, 2, 1, samples=3200, label_len=3, seed=1))
    return list(synthetic_visual_batches(tok, 2, 1, frames=6, size=24, label_len=2, seed=1))


def _jax_step(jt):
    """The JAX trainer's ``train_step`` body, also returning the gradients."""
    def step(state, batch):
        rng, step_rng = jax.random.split(state["rng"])
        (loss, (_, _, new_stats)), grads = jax.value_and_grad(
            lambda p: jt._loss(p, state["batch_stats"], batch, True, step_rng),
            has_aux=True)(state["params"])
        updates, opt_state = jt._tx.update(grads, state["opt_state"])
        return ({"params": optax.apply_updates(state["params"], updates), "opt_state": opt_state,
                 "batch_stats": new_stats, "rng": rng}, loss, grads)
    return jax.jit(step)


@pytest.fixture(scope="module")
def refs(tok):
    """Three JAX steps of each family's trainer from one state."""
    out = {}
    for family, make in (("audio", j_make_audio), ("visual", j_make_visual)):
        cfg = _cfg()
        if family == "visual":
            cfg.train.lr_schedule, cfg.train.warmup_steps = "noam", 3
        jt = make(cfg, tok)
        batch = _batches(family, tok)[0]
        state = jt.init_state(0, batch)
        sd0 = serialization.to_state_dict(jax.device_get(state))
        convert = {"audio": audio_only_from_jax, "visual": visual_only_from_jax}[family]
        step = _jax_step(jt)
        s, steps = state, []
        for _ in range(3):
            s, loss, grads = step(s, batch)
            variables = {"params": to_np(s["params"])}
            if s["batch_stats"]:
                variables["batch_stats"] = to_np(s["batch_stats"])
            steps.append({"loss": float(loss), "grads": convert({"params": to_np(grads)}),
                          "state": convert(variables)})
        out[family] = {"cfg": cfg, "jt": jt, "batch": batch, "sd0": sd0, "steps": steps,
                       "jstate0": jax.device_get(jt.init_state(0, batch))}
    return out


def _port(ref, family):
    make = make_audio_trainer if family == "audio" else make_visual_trainer
    trainer = make(port_config(ref["cfg"]), CharTokenizer(VOCAB), device="cpu")
    state = trainer.init_state(0)
    state.load_state_dict(single_modality_state_from_jax(ref["sd0"], family))
    return trainer, state


@pytest.mark.parametrize("train", [False, True])
def test_visual_only_forward_matches_jax(train):
    cfg = _cfg()
    rng = np.random.default_rng(0)
    lips = rng.uniform(size=(2, 6, 1, 24, 24)).astype(np.float32)
    lengths = np.array([6, 4], np.int32)
    model = JVisualOnly(cfg.model)
    variables = perturb_batch_stats(jax.jit(model.init)(jax.random.PRNGKey(0), lips, lengths))
    if train:
        (jlp, jlen), upd = model.apply(variables, lips, lengths, train=True,
                                       mutable=["batch_stats"])
    else:
        jlp, jlen = model.apply(variables, lips, lengths)
    port = VisualOnlyCTC(port_config(cfg).model)
    port.load_state_dict(visual_only_from_jax(variables), strict=True)
    with torch.no_grad():
        lp, lens = port(torch.from_numpy(lips), torch.from_numpy(lengths), train=train)
        _, full = port(torch.from_numpy(lips))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlen))
    assert full.tolist() == [6, 6] and full.dtype == torch.int32
    if train:
        want = visual_only_from_jax({"params": variables["params"],
                                     "batch_stats": to_np(upd["batch_stats"])})
        for k, v in port.state_dict().items():
            if "running" in k:
                torch.testing.assert_close(v, want[k], rtol=1e-4, atol=1e-5, msg=k)


@pytest.mark.parametrize("family", ["audio", "visual"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(refs, family, n_steps):
    ref = refs[family]
    trainer, state = _port(ref, family)
    initial = {k: v.clone() for k, v in state.model.state_dict().items()}
    for i in range(n_steps):
        state, loss = trainer.train_step(state, ref["batch"])
        want = ref["steps"][i]
        np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-4, atol=1e-6)
        for name, p in state.model.named_parameters():
            g, g_ref = p.grad, want["grads"][name]
            assert torch.linalg.vector_norm(g - g_ref) <= \
                1e-3 * torch.linalg.vector_norm(g_ref) + 1e-7, f"step {i + 1} grad {name}"
    assert state.step == state.optimizer.updates == n_steps
    want = ref["steps"][n_steps - 1]["state"]
    moved = ref["steps"][0]["grads"]
    n_stats = 0
    for name, value in state.model.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(value, want[name], rtol=1e-4, atol=1e-5, msg=name)
            assert not torch.equal(value, initial[name]), name
            n_stats += 1
            continue
        g = moved[name].abs()
        sel = (g >= 1e-7) & (g >= 1e-6 * g.max())
        diff = (value - want[name])[sel].abs()
        assert diff.numel() == 0 or diff.max() <= 2e-2 * LR * n_steps, name
        assert not torch.equal(value, initial[name]) or not sel.any(), name
    assert (n_stats > 0) == (family == "visual")


def _toy(seed=0):
    """A flax-shaped tree and a module with the same parameters."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in (("a", (3, 4)), ("b", (5,)), ("w", (2, 2)))}
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    return params, module


@pytest.mark.parametrize("schedule,clip", [("constant", None), ("warmup_cosine", 0.5),
                                           ("noam", 2.0)])
def test_one_group_adam_matches_the_optax_chain(tok, schedule, clip):
    """The families' optimizer: JAX builds ``chain(clip_by_global_norm,
    adam(make_lr_schedule))`` (``single_modality.py:33-46``); the port's
    ``make_optimizer`` gives ``GroupAdam`` one group, whose clip norm is the
    global norm."""
    cfg = _cfg()
    cfg.train.lr_schedule, cfg.train.grad_clip_norm = schedule, clip
    cfg.train.warmup_steps, cfg.train.decay_steps, cfg.train.grad_accum_steps = 2, 6, 3
    jt = j_make_audio(cfg, tok)
    params, module = _toy()
    opt = jt._tx.init(params)
    adam = SingleModalityTrainer(port_config(cfg), module, CharTokenizer(VOCAB),
                                 device="cpu").make_optimizer()
    assert isinstance(adam, GroupAdam) and adam.names["audio"] == []
    rng = np.random.default_rng(1)
    for i in range(7):
        grads = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
                 for k, v in params.items()}
        updates, opt = jt._tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        for name, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[name].copy())
        assert adam.step()                     # grad_accum_steps is not read
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[name]),
                                       rtol=1e-5, atol=1e-8, err_msg=f"update {i} {name}")


@pytest.mark.parametrize("family", ["audio", "visual"])
def test_flush_batch_loss_equals_the_unpadded_batch(refs, family):
    trainer, state = _port(refs[family], family)
    batch = refs[family]["batch"]
    flush = {k: np.concatenate([v, v[-1:]]) for k, v in batch.items()}
    flush["valid"] = np.array([1, 1, 0], np.float32)
    flush["num_real"] = np.int32(2)
    with torch.no_grad():
        plain = trainer._loss(state.model, trainer._place(batch), False)[0]
        weighted = trainer._loss(state.model, trainer._place(flush), False)[0]
    torch.testing.assert_close(weighted, plain, rtol=1e-6, atol=0)
    assert trainer.evaluate([flush], state)[0] == pytest.approx(float(plain), rel=1e-6)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("families") / "corpus"))


@pytest.mark.parametrize("family", ["audio", "visual"])
def test_utterance_batches_match_jax(corpus, tok, family):
    entries, _ = build_data_list(corpus["json_folder"], corpus["npy_dir"], corpus["text_dir"],
                                 corpus["wav_dir"])
    j_entries, _ = j_build_data_list(corpus["json_folder"], corpus["npy_dir"],
                                     corpus["text_dir"], corpus["wav_dir"])
    n = 5 if family == "visual" else len(entries)
    got = list(utterance_batches(entries[:n], CharTokenizer(VOCAB), family, 2))
    want = list(j_utterances(j_entries[:n], tok, family, 2))
    assert len(got) == len(want) == -(-n // 2)
    assert int(got[-1]["num_real"]) == 1 and got[-1]["valid"].tolist() == [1.0, 0.0]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
            if family == "visual" and k == "inputs":    # JAX may resize natively
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_evaluate_matches_jax(refs, corpus, tok):
    """On the corpus's audio utterances (a flush batch included), greedy and
    prefix beam."""
    ref = refs["audio"]
    jt, jstate = ref["jt"], ref["jstate0"]
    entries, _ = j_build_data_list(corpus["json_folder"], corpus["npy_dir"], corpus["text_dir"],
                                   corpus["wav_dir"])
    batches = list(j_utterances(entries[:3], tok, "audio", 2))
    trainer, state = _port(ref, "audio")
    for use_beam in (False, True):
        got = trainer.evaluate(batches, state, use_beam=use_beam)
        want = jt.evaluate(batches, jstate, use_beam=use_beam)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
        assert got[1:] == pytest.approx(want[1:], abs=1e-12)


# -- the CLI ------------------------------------------------------------------

@pytest.fixture(scope="module")
def audio_family(corpus, tmp_path_factory):
    """``--family=audio`` on the corpus: one epoch, then a resume to a second
    (the resumed ``fit``'s starting generator is kept)."""
    root = tmp_path_factory.mktemp("audio_family")
    args = TINY + [f"data.{k}={v}" for k, v in corpus.items()] + [
        "--family=audio", "train.batch_size=8", "train.eval_batch_size=2",
        f"train.checkpoint_dir={root}"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pmain.main(args + ["train.max_epochs=1"])
    first = restore_checkpoint(str(root / "last.ckpt"))
    seen = {}
    fit = SingleModalityTrainer.fit

    def spy(self, state, *a, **kw):
        seen["generator"], seen["start_epoch"] = state.generator.get_state(), kw["start_epoch"]
        return fit(self, state, *a, **kw)

    SingleModalityTrainer.fit = spy
    try:
        with contextlib.redirect_stdout(out):
            pmain.main(args + ["train.max_epochs=2"])
    finally:
        SingleModalityTrainer.fit = fit
    return args, root, first, seen, out.getvalue()


def test_audio_family_trains_and_resumes_with_its_generator(audio_family):
    args, root, first, seen, out = audio_family
    assert first["epoch"] == 1 and first["state"]["step"] == 4     # 31 utterances, B = 8
    assert "[epoch 1] train_loss=" in out and "[epoch 2] train_loss=" in out
    assert f"resuming from {root / 'last.ckpt'} at epoch 2" in out
    assert seen["start_epoch"] == 2
    # JAX restores its dropout key with the rest (main.py:574).
    assert torch.equal(seen["generator"], first["state"]["generator"])
    assert not torch.equal(seen["generator"], torch.Generator().manual_seed(42).get_state())
    last = restore_checkpoint(str(root / "last.ckpt"))
    assert last["epoch"] == 2 and last["state"]["step"] == 8
    assert set(last["state"]["model"]) == {
        k for k in last["state"]["model"] if k.startswith(("audio_encoder.", "decoder.head."))}
    assert {"best_wer.ckpt", "best_loss.ckpt"} <= set(os.listdir(root))


def test_audio_family_eval_infer_and_stream(audio_family, tmp_path, capsys):
    args, root, _, _, _ = audio_family
    pmain.main(args + ["--eval"])
    out = capsys.readouterr().out.strip().splitlines()
    report = json.loads(out[-1])
    assert report["family"] == "audio" and report["checkpoint"] == str(root / "best_wer.ckpt")
    assert set(report["decode"]) == {"greedy", "prefix_beam"}
    assert out[0].startswith("[eval audio] greedy: loss=")
    pmain.main(args + ["--infer"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == f"transcribing (audio) with {root / 'best_wer.ckpt'}"
    assert [ln.split("]")[0] for ln in out[1:-1]] == ["[utt 0", "[utt 1"]
    assert out[-1] == "transcribed 2 utterances"
    wav = str(tmp_path / "x.wav")
    write_wav(wav, np.random.default_rng(0).standard_normal(16000) * 0.3, 16000)
    pmain.main([a for a in args if a != "--family=audio"] + [
        f"--stream={wav}", "decode.stream_chunk_seconds=0.2",
        "decode.stream_context_seconds=0.2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"streaming {wav} (1.0 s) with {root / 'best_wer.ckpt'}, chunk=0.2s")
    with pytest.raises(SystemExit, match="has none"):
        pmain.main(args + ["--infer", f"--export={tmp_path / 'x'}"])


def test_visual_family_grafts_into_the_flagship(tmp_path, monkeypatch, capsys):
    """``--family=visual`` (``--synthetic``, 96x96 lips) then a flagship epoch
    with ``train.visual_init_ckpt``: its visual encoder, BatchNorm
    statistics included, is the visual family's at the start of ``fit``."""
    vis = tmp_path / "visual"
    pmain.main(TINY + SMALL + ["--synthetic", "--family=visual", "train.max_epochs=1",
                               f"train.checkpoint_dir={vis}"])
    out = capsys.readouterr().out
    assert "[epoch 1] train_loss=" in out
    pmain.main(TINY + SMALL + ["--synthetic", "--family=visual", "--eval",
                               f"train.checkpoint_dir={vis}"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["family"] == "visual"
    src = restore_checkpoint(str(vis / "last.ckpt"))["state"]["model"]
    seen = {}
    monkeypatch.setattr(MultiSpeakerTrainer, "fit", lambda self, state, *a, **kw: seen.update(
        model={k: v.clone() for k, v in state.model.state_dict().items()}))
    source = str(vis / "last.ckpt")
    pmain.main(TINY + SMALL + ["--synthetic", "train.max_epochs=1", "data.video_buckets=(64,)",
                               f"train.checkpoint_dir={tmp_path / 'av'}",
                               f"train.visual_init_ckpt={source}"])
    assert f"grafted visual encoder from {source}" in capsys.readouterr().out
    visual = [k for k in seen["model"] if k.startswith("visual_encoder.")]
    assert visual and any("running_mean" in k for k in visual)
    for k in visual:
        assert torch.equal(seen["model"][k], src[k]), k


def _tiny_visual_trainer(tmp_path, **train):
    cfg = port_config(_cfg())
    cfg.train.checkpoint_dir, cfg.train.max_epochs = str(tmp_path), 2
    for k, v in train.items():
        setattr(cfg.train, k, v)
    trainer = make_visual_trainer(cfg, CharTokenizer(VOCAB), device="cpu")
    return trainer, trainer.init_state(0)


def test_fit_saves_the_previous_epoch_on_sigterm(tmp_path):
    """A real SIGTERM during the second epoch's first step: ``fit`` saves
    ``last.ckpt`` as epoch 1 and returns (``single_modality.py:196-201``)."""
    import signal

    trainer, state = _tiny_visual_trainer(tmp_path)
    batches = _batches("visual", JTokenizer(VOCAB))
    epochs = []

    def train_factory():
        epochs.append(len(epochs) + 1)
        for b in batches * 2:
            if len(epochs) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    logs = []
    state = trainer.fit(state, train_factory, lambda: iter(batches), log_fn=logs.append)
    assert logs[0].startswith("[epoch 1] train_loss=") and "utt/s=" in logs[0]
    assert logs[1].startswith(f"preempted: saved {tmp_path / 'last.ckpt'} mid-epoch 2")
    saved = restore_checkpoint(str(tmp_path / "last.ckpt"))
    assert saved["epoch"] == 1 and saved["state"]["step"] == state.step == 2


@pytest.mark.parametrize("async_dispatch", [True, False])
def test_fit_raises_on_a_non_finite_loss(tmp_path, async_dispatch):
    from multimodal_av_model_tpu_torch.train import NonFiniteLossError

    trainer, state = _tiny_visual_trainer(tmp_path, async_dispatch=async_dispatch)
    bad = dict(_batches("visual", JTokenizer(VOCAB))[0])
    bad["inputs"] = np.full_like(bad["inputs"], np.nan)
    with pytest.raises(NonFiniteLossError):
        trainer.fit(state, lambda: iter([bad]), lambda: iter([bad]))
    assert not os.path.exists(tmp_path / "last.ckpt")
