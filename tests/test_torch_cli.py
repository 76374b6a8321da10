"""PyTorch port, the command line: ``multimodal_av_model_tpu_torch.main.main``
with ``--device=cpu`` at tiny widths, on a corpus written in the AI-Hub
layout and on ``--synthetic`` pairs: train, resume, ``--eval``, ``--infer``,
the visual-encoder graft with a frozen trunk, the flags the port refused
until item 7 and 8 (which now train) and the families' refusals, and ``--infer --export`` against the artifact it
writes.  Numbers
are compared exactly (parameters after a frozen epoch).
``--stream`` in its three modes and ``--infer decode.quantize=true`` run
beside the JAX CLI on the same weights (converted with ``compat``) and
media, and print the same texts.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from multimodal_av_model_tpu_torch import main as pmain
from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer, restore_checkpoint
from test_torch_fit import write_corpus

VOCAB = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
TINY = [
    "model.audio.d_model=32", "model.audio.num_layers=2", "model.audio.num_heads=2",
    "model.audio.ffn_dim=64", "model.audio.conv_kernel_size=7",
    "model.audio.middle_layers=(0,1)", "model.audio.output_dim=48",
    "model.visual.frontend_channels=8", "model.visual.resnet_layers=(1,1,1,1)",
    "model.visual.resnet_channels=(8,12,16,24)", "model.visual.output_dim=24",
    "model.fusion.fused_dim=16", "model.fusion.num_heads=2",
    "model.contrastive.projection_dim=8", "model.dtype=float32",
    f"data.vocab_path={VOCAB}", "--device=cpu",
]
SMALL = ["data.num_pairs_per_epoch=4", "data.eval_pairs=2", "train.batch_size=2",
         "train.eval_batch_size=2", "train.log_every=100"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models here run many small ops, which torch's thread pool
    slows down when the suite's workers already share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus_args(tmp_path_factory):
    dirs = write_corpus(str(tmp_path_factory.mktemp("cli") / "corpus"))
    return TINY + SMALL + [f"data.{k}={v}" for k, v in dirs.items()] + [
        "data.video_buckets=(32,)"]


@pytest.fixture(scope="module")
def trained(corpus_args, tmp_path_factory):
    """One epoch trained, then resumed to a second; the state ``fit`` got on
    the resume is kept."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    args = corpus_args + [f"train.checkpoint_dir={ckpt}"]
    pmain.main(args + ["train.max_epochs=1"])
    first = restore_checkpoint(os.path.join(ckpt, "last.ckpt"))
    seen = {}
    fit = MultiSpeakerTrainer.fit

    def spy(self, state, *a, **kw):
        seen["step"], seen["generator"] = state.step, state.generator.get_state()
        seen["start_epoch"] = kw.get("start_epoch")
        return fit(self, state, *a, **kw)

    MultiSpeakerTrainer.fit = spy
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            pmain.main(args + ["train.max_epochs=2"])
    finally:
        MultiSpeakerTrainer.fit = fit
    seen["out"] = out.getvalue()
    return args, ckpt, first, seen


def test_train_then_resume(trained, capsys):
    args, ckpt, first, seen = trained
    assert first["epoch"] == 1 and first["state"]["step"] == 2
    assert seen["start_epoch"] == 2 and seen["step"] == 2
    # Everything is restored but the dropout generator, which starts afresh
    # from data.seed, as JAX keeps its fresh PRNG key.
    assert torch.equal(seen["generator"], torch.Generator().manual_seed(42).get_state())
    last = restore_checkpoint(os.path.join(ckpt, "last.ckpt"))
    assert last["epoch"] == 2 and last["state"]["step"] == 4
    with open(os.path.join(ckpt, "eval_log.csv")) as f:
        assert [r.split(",")[0] for r in f.read().split()] == ["epoch", "1", "2"]
    assert {"best_wer.ckpt", "best_loss.ckpt", "best.json", "train_log.csv"} <= \
        set(os.listdir(ckpt))


def test_resume_prints_where_it_resumes(trained):
    _, ckpt, _, seen = trained
    assert f"resuming from {ckpt}/last.ckpt at epoch 2" in seen["out"]
    assert "[epoch 2]" in seen["out"] and "[epoch 1]" not in seen["out"]


def test_eval_prints_one_json_line(trained, capsys):
    args, ckpt, _, _ = trained
    pmain.main(args + ["--eval"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["checkpoint"] == os.path.join(ckpt, "best_wer.ckpt")
    assert report["epoch"] in (1, 2) and set(report["decode"]) == {"greedy", "prefix_beam"}
    for algo in report["decode"].values():
        assert algo["cer"] >= 0 and algo["wer"] >= 0 and algo["eval_loss"] > 0


def test_infer_prints_transcripts(trained, capsys):
    args, ckpt, _, _ = trained
    pmain.main(args + ["--infer"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"transcribing with {os.path.join(ckpt, 'best_wer.ckpt')}"
    assert [ln.split(":")[0] for ln in out[1:-1]] == [
        "[utt 0] speaker1", "[utt 0] speaker2", "[utt 1] speaker1", "[utt 1] speaker2"]
    assert out[-1] == "transcribed 2 pairs"


def test_infer_export_writes_an_artifact_with_the_same_texts(trained, tmp_path, capsys):
    """``--infer --export=<dir>`` exports at the first eval batch, then
    transcribes; ``ExportedTranscriber.load`` of the artifact, with no model
    class or config, gives the texts ``--infer`` printed."""
    from multimodal_av_model_tpu_torch.config import from_flat_overrides
    from multimodal_av_model_tpu_torch.infer import ExportedTranscriber
    from multimodal_av_model_tpu_torch.text import CharTokenizer

    args, _, _, _ = trained
    out_dir = str(tmp_path / "artifact")
    pmain.main(args + ["--infer", f"--export={out_dir}"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"exported serving artifact to {out_dir} (")
    assert out[-1] == "transcribed 2 pairs"
    printed = [ln.split(": ", 1)[1] for ln in out if ln.startswith("[utt ")]
    assert sorted(os.listdir(out_dir)) == ["meta.json", "model.pt2", "vocab.txt"]

    served = ExportedTranscriber.load(out_dir, device="cpu")
    cfg = from_flat_overrides([a for a in args if not a.startswith("--")])
    tok = CharTokenizer(VOCAB)
    cfg.model.decoder.vocab_size = tok.vocab_size
    _, val_factory = pmain.build_data(cfg, tok, False, "cpu", device_put=False)
    texts = []
    for batch in val_factory():
        pairs = served.transcribe(batch)[: int(batch.get("num_real", 2))]
        texts += [t for pair in pairs for t in pair]
    assert texts == printed and len(texts) == 4
    with pytest.raises(SystemExit, match="pass --infer"):
        pmain.main(args + [f"--export={out_dir}"])


def test_synthetic_training(tmp_path, capsys):
    pmain.main(TINY + SMALL + ["--synthetic", "train.max_epochs=1", "data.video_buckets=(64,)",
                               f"train.checkpoint_dir={tmp_path}"])
    out = capsys.readouterr().out
    assert "[epoch 1] train_loss=" in out
    assert restore_checkpoint(str(tmp_path / "last.ckpt"))["state"]["step"] == 2
    pmain.main(TINY + SMALL + ["--synthetic", "--infer", "data.video_buckets=(64,)",
                               f"train.checkpoint_dir={tmp_path}"])
    assert capsys.readouterr().out.strip().endswith("transcribed 2 pairs")


def test_visual_init_ckpt_with_a_frozen_trunk(trained, tmp_path, capsys):
    args, ckpt, _, _ = trained
    source = os.path.join(ckpt, "last.ckpt")
    pmain.main(args + [f"train.checkpoint_dir={tmp_path}", "train.max_epochs=1",
                       f"train.visual_init_ckpt={source}", "train.freeze_visual_trunk=true"])
    assert f"grafted visual encoder from {source}" in capsys.readouterr().out
    src = restore_checkpoint(source)["state"]["model"]
    final = restore_checkpoint(str(tmp_path / "last.ckpt"))["state"]["model"]
    visual = [k for k in final if k.startswith("visual_encoder.")]
    assert visual
    for k in visual:
        if "running" not in k:                  # BatchNorm statistics still update
            assert torch.equal(final[k], src[k]), k
    assert not torch.equal(final["decoder.head.weight"], src["decoder.head.weight"])


@pytest.mark.parametrize("arg,item", [
    ("mesh.fsdp=true", "item 7"), ("compile_cache_dir=/x", "item 8"),
    ("train.checkpoint_layout=sharded", "item 7"),
])
def test_refused_flags_name_their_roadmap_item(arg, item, tmp_path, capsys, monkeypatch):
    """The flags the CLI refused until their ROADMAP.md item was ported now
    train (here outside ``torchrun``: no mesh; ``tests/test_torch_sharded_
    checkpoints.py`` runs the CLI under it)."""
    from multimodal_av_model_tpu_torch.ops import cuda_build
    from multimodal_av_model_tpu_torch.runtime import compile_cache

    monkeypatch.setattr(cuda_build, "_build_root", cuda_build._build_root)
    monkeypatch.setattr(compile_cache, "_enabled", None)
    assert not hasattr(pmain, "REFUSED"), item
    ckpt = tmp_path / "ckpt"
    pmain.main(TINY + SMALL + ["--synthetic", "train.max_epochs=1", f"train.checkpoint_dir={ckpt}",
                               arg.replace("=/x", f"={tmp_path / 'cache'}")])
    assert "[epoch 1] train_loss=" in capsys.readouterr().out
    if arg.startswith("train.checkpoint_layout"):
        assert os.path.isfile(ckpt / "last.ckpt" / "COMMITTED")
    else:
        assert os.path.isfile(ckpt / "last.ckpt")
    if arg.startswith("compile_cache_dir"):
        assert cuda_build.build_dir() == str(tmp_path / "cache" / "kernels")


@pytest.mark.parametrize("args,message", [
    (["--family=bogus"], "--family must be av|audio|visual|ssl, got bogus"),
    (["--infer", "--family=ssl"], "--infer serves decoder-bearing families"),
    (["--eval", "--family=ssl"], "finetune an SSL checkpoint first"),
    (["--synthetic", "--eval", "--family=audio"], "no checkpoint under"),
])
def test_family_refusals_are_jax_s(args, message, tmp_path):
    """The refusals the JAX CLI makes for the families (``main.py:481-500``,
    ``:597-598``, ``:627-640``), with its messages."""
    with pytest.raises(SystemExit, match=message):
        pmain.main(TINY + args + [f"train.checkpoint_dir={tmp_path}"])
    assert not os.listdir(tmp_path)


def test_unknown_flags_and_fields_fail(tmp_path):
    with pytest.raises(SystemExit, match="unknown flag"):
        pmain.main(TINY + ["--no-such-flag"])
    with pytest.raises(AttributeError, match="unknown config field"):
        pmain.main(TINY + ["model.frontend.use_pallas=true"])
    with pytest.raises(SystemExit, match="--device must be"):
        pmain.main(["--device=tpu"])


def test_without_a_card_the_cli_needs_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device=cpu"):
        pmain.main(["--synthetic", f"train.checkpoint_dir={tmp_path}"])
    assert not os.listdir(tmp_path)


# -- streaming and int8 serving, beside the JAX CLI -----------------------------

J_TINY = [a for a in TINY if a != "--device=cpu"] + ["model.frontend.use_pallas=false"]
AUDIO_TINY = ["model.audio.d_model=16", "model.audio.num_layers=2", "model.audio.num_heads=2",
              "model.audio.ffn_dim=32", "model.audio.output_dim=16",
              "model.audio.middle_layers=(0,1)", "model.frontend.n_mels=16",
              "model.dtype=float32", f"data.vocab_path={VOCAB}",
              "decode.stream_chunk_seconds=0.2", "decode.stream_context_seconds=0.2"]


def _run_both(port_args, jax_args):
    """The port's and the JAX CLI's standard output for the same call."""
    from multimodal_av_model_tpu.main import main as jmain

    out = {}
    for name, fn, args in (("port", pmain.main, port_args + ["--device=cpu"]),
                           ("jax", jmain, jax_args + ["model.frontend.use_pallas=false"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(args)
        out[name] = buf.getvalue().splitlines()
    return out["port"], out["jax"]


@pytest.fixture(scope="module")
def audio_ckpts(tmp_path_factory):
    """One tiny ``AudioOnlyCTC``'s weights as a JAX checkpoint and as a port
    checkpoint, and three WAVs (0.9, 0.5 and 1.3 s)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multimodal_av_model_tpu.config import from_flat_overrides
    from multimodal_av_model_tpu.data.audio_io import write_wav
    from multimodal_av_model_tpu.models import AudioOnlyCTC as JAudioOnly
    from multimodal_av_model_tpu.train.checkpoints import save_checkpoint as j_save
    from multimodal_av_model_tpu_torch.compat import audio_only_from_jax
    from multimodal_av_model_tpu_torch.train import save_checkpoint

    root = tmp_path_factory.mktemp("stream")
    cfg = from_flat_overrides(AUDIO_TINY[:-4] + ["model.decoder.vocab_size=800"])
    v = jax.tree.map(np.asarray, jax.jit(JAudioOnly(cfg.model, dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 6400)), jnp.ones((1, 6400), bool)))
    j_save(str(root / "jax" / "last.ckpt"), {"state": {"params": v["params"]}, "epoch": 1})
    save_checkpoint(str(root / "port" / "last.ckpt"),
                    {"state": {"model": audio_only_from_jax(v)}, "epoch": 1})
    rng = np.random.default_rng(0)
    wavs = []
    for i, sec in enumerate((0.9, 0.5, 1.3)):
        wavs.append(str(root / f"a{i}.wav"))
        write_wav(wavs[-1], rng.standard_normal(int(sec * 16000)) * 0.3, 16000)
    return root, wavs


@pytest.mark.parametrize("mode", ["one file", "pool", "int8 pool"])
def test_stream_audio_prints_the_jax_texts(audio_ckpts, mode):
    """``--stream=x.wav`` (prefix beam) and ``--stream=a.wav,b.wav,c.wav``
    (the pool, greedy; fp and ``decode.quantize=true``)."""
    root, wavs = audio_ckpts
    spec = wavs[0] if mode == "one file" else ",".join(wavs)
    extra = ["decode.quantize=true"] if mode == "int8 pool" else []
    got, want = _run_both(
        [f"--stream={spec}", f"train.checkpoint_dir={root / 'port'}"] + AUDIO_TINY + extra,
        [f"--stream={spec}", f"train.checkpoint_dir={root / 'jax'}"] + AUDIO_TINY + extra)
    assert got[0] == want[0].replace(str(root / "jax"), str(root / "port"))
    assert got[0].startswith("streaming ")
    assert got[1:] == want[1:] and len(got) > 1


def test_stream_av_prints_the_jax_texts(tmp_path):
    """``--stream=lips1.avi,lips2.avi,mix.wav``: the tiny flagship (BiLSTM,
    GroupNorm) on AVIs and a WAV that the port's own writers made."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multimodal_av_model_tpu.config import from_flat_overrides
    from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
    from multimodal_av_model_tpu.train.checkpoints import save_checkpoint as j_save
    from multimodal_av_model_tpu_torch.compat import from_jax_variables
    from multimodal_av_model_tpu_torch.data.audio_io import write_wav
    from multimodal_av_model_tpu_torch.data.avi import write_avi
    from multimodal_av_model_tpu_torch.train import save_checkpoint

    args = [a for a in J_TINY if not a.startswith("model.frontend.use_pallas")] + [
        "model.visual.norm=group", "decode.stream_chunk_seconds=0.1",
        "decode.stream_context_seconds=0.1"]
    cfg = from_flat_overrides(args + ["model.decoder.vocab_size=800"])
    z, m, n = (jnp.zeros((1, 6, 1, 24, 24)), jnp.full((1, 6 * 534), 2, jnp.int32),
               jnp.full((1,), 6, jnp.int32))
    v = jax.tree.map(np.asarray, jax.jit(JModel(cfg.model, dtype=jnp.float32).init)(
        jax.random.PRNGKey(0), z, z, jnp.zeros((1, 6 * 534)), m, m, n, n))
    j_save(str(tmp_path / "jax" / "last.ckpt"), {"state": {"params": v["params"]}, "epoch": 1})
    save_checkpoint(str(tmp_path / "port" / "last.ckpt"),
                    {"state": {"model": from_jax_variables(v)}, "epoch": 1})
    rng = np.random.default_rng(0)
    media = [str(tmp_path / f) for f in ("lips1.avi", "lips2.avi", "mix.wav")]
    for path in media[:2]:
        write_avi(path, rng.integers(0, 256, size=(10, 32, 32, 3), dtype=np.uint8), fps=30)
    write_wav(media[2], rng.standard_normal(10 * 534) * 0.3, 16000)
    spec = ",".join(media)
    got, want = _run_both(
        [f"--stream={spec}", f"train.checkpoint_dir={tmp_path / 'port'}"] + args,
        [f"--stream={spec}", f"train.checkpoint_dir={tmp_path / 'jax'}"] + args)
    assert got[0] == want[0].replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert got[0].startswith("streaming AV ")
    assert got[1:] == want[1:] and any(ln.startswith("[speaker") for ln in got)


def test_infer_int8_prints_the_jax_texts(corpus_args, tmp_path):
    """``--infer decode.quantize=true`` on the corpus's fixed eval pairs (the
    ``--synthetic`` source would not do: the JAX CLI draws an example batch
    from it first, so it transcribes later pairs): the parameter bytes and
    every transcript line equal the JAX CLI's."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multimodal_av_model_tpu.config import from_flat_overrides
    from multimodal_av_model_tpu.models import MultiSpeakerAVModel as JModel
    from multimodal_av_model_tpu.train.checkpoints import save_checkpoint as j_save
    from multimodal_av_model_tpu_torch.compat import from_jax_variables
    from multimodal_av_model_tpu_torch.train import save_checkpoint
    from test_torch_models import perturb_batch_stats

    args = [a for a in corpus_args if a != "--device=cpu"] + ["decode.quantize=true", "--infer"]
    cfg = from_flat_overrides([a for a in args if not a.startswith("--")]
                              + ["model.decoder.vocab_size=800"])
    z, m, n = (jnp.zeros((1, 6, 1, 24, 24)), jnp.full((1, 6 * 534), 2, jnp.int32),
               jnp.full((1,), 6, jnp.int32))
    v = perturb_batch_stats(jax.jit(JModel(cfg.model, dtype=jnp.float32).init)(
        jax.random.PRNGKey(1), z, z, jnp.zeros((1, 6 * 534)), m, m, n, n))
    j_save(str(tmp_path / "jax" / "last.ckpt"), {"state": dict(v), "epoch": 1})
    save_checkpoint(str(tmp_path / "port" / "last.ckpt"),
                    {"state": {"model": from_jax_variables(v)}, "epoch": 1})
    got, want = _run_both(args + [f"train.checkpoint_dir={tmp_path / 'port'}"],
                          args + [f"train.checkpoint_dir={tmp_path / 'jax'}"])
    assert got[0] == want[0] and got[0].startswith("int8 weight-only serving: ")
    assert [ln for ln in got if ln.startswith("[utt ")] == \
        [ln for ln in want if ln.startswith("[utt ")]
    assert got[-1] == want[-1] == "transcribed 2 pairs"
