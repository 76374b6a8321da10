"""The port's command line: train, evaluate, transcribe or stream.

    python -m multimodal_av_model_tpu_torch.main [--synthetic] [--family=av|audio|visual|ssl]
        [--eval | --infer [--export=DIR]] [--stream=FILES] [--device=cuda|cpu]
        [key.path=value ...]
    torchrun --nproc-per-node=N -m multimodal_av_model_tpu_torch.main [mesh.model_axis=M]
        [mesh.fsdp=true] [train.checkpoint_layout=sharded] [key.path=value ...]

Mirrors ``multimodal_av_model_tpu/main.py``: ``build_data``
(``main.py:27-110``), ``run_infer`` and ``run_eval`` (``main.py:113-205``),
``run_stream_av`` and ``run_stream`` (``main.py:208-391``), the families
(``main.py:393-575``) and ``main`` (``main.py:578-752``):

* the real-data branch reads the AI-Hub layout (``data.json_folder``,
  ``npy_dir``, ``text_dir``, ``wav_dir``): manifest, seeded 90/5/5 split,
  speaker-distinct pairs, length buckets, a prefetch thread, and with
  ``data.device_preprocess`` (the default) the raw crops and waveforms go to
  the device, where mixing and K2 run; ``--synthetic`` trains on seeded
  random pairs preprocessed on the host;
* ``model.arch=avhubert`` (``models/avhubert.py``, sized by
  ``model.avhubert.*``) takes the place of the flagship in training,
  ``--eval`` and ``--infer`` on one device; the paths that serve the
  flagship alone (``--stream``, ``--export``, the other families,
  ``decode.quantize``, a ``torchrun`` mesh) refuse it;
* training the flagship (``--family=av``, the default):
  ``train.freeze_visual_trunk`` freezes the visual encoder,
  ``train.visual_init_ckpt`` grafts the visual encoder of a port checkpoint
  (a flagship or a ``--family=visual`` one), ``train.audio_init_ckpt`` the
  audio encoder of a ``--family=ssl`` checkpoint (without its
  ``mask_embedding``), and an existing ``last.ckpt`` under
  ``train.checkpoint_dir`` resumes the run at its next epoch with everything
  but the dropout generator, which starts afresh from ``data.seed`` (as JAX
  keeps its fresh PRNG key); then ``fit``;
* ``--family=audio`` / ``visual`` train ``AudioOnlyCTC`` / ``VisualOnlyCTC``
  in f32 on single utterances (``utterance_batches``: ``[B, 160000]``
  waveforms, or ``[B, 448, 1, 96, 96]`` lips preprocessed on the host), and
  ``--family=ssl`` pretrains the audio encoder by masked-span InfoNCE on the
  flagship's batches, with spans seeded by ``data.seed * 1009 + epoch``.
  These resume with their whole state, the dropout generator included (JAX
  restores its key with the rest);
* ``--eval`` prints one JSON line with greedy and ``decode.algorithm``
  scores of ``best_wer.ckpt`` (else ``last.ckpt``); ``--infer`` prints
  ``[utt n] speaker1: ...`` lines for the eval pairs (``[utt n] <text>`` per
  utterance for ``audio`` and ``visual``), from int8 weights with
  ``decode.quantize=true``; ``--infer --export=<dir>`` first writes the
  flagship's serving artifact at the first eval batch's shapes
  (``main.py:113-146``), which ``infer.ExportedTranscriber.load(<dir>)``
  serves; ``--family=ssl`` has no decoder, so it has neither;
* ``--stream=x.wav`` streams one file through ``StreamingAudioTranscriber``,
  ``--stream=a.wav,b.wav,...`` the files together through a
  ``StreamingPool``: both load an ``AudioOnlyCTC`` checkpoint (the port's
  layout, its state dict under ``state["model"]``; ``--family=audio``
  writes one) and take ``decode.stream_chunk_seconds``,
  ``decode.stream_context_seconds`` and ``decode.quantize``;
  ``--stream=lips1.avi,lips2.avi,mix.wav`` streams the flagship
  (``StreamingAVTranscriber``) on host-preprocessed lips;
* under ``torchrun`` (``main.py:657-691``) the flagship trains over a
  ``(data, model)`` mesh of all the ranks (``mesh.model_axis`` of them per
  tensor-parallel group, inside a node), with ``mesh.fsdp`` sharding the
  parameters and Adam over ``data``; each process loads its share of
  ``train.batch_size`` and ``train.eval_batch_size``.  As in JAX, every
  process draws the same seeded pairs, so each pair appears once per data
  rank in the global batch (ROADMAP Queue 3).  ``train.checkpoint_layout=
  sharded`` writes DCP directories that each rank writes its shards into;
* ``compile_cache_dir=<dir>`` builds K1, K2 and the host ops under ``<dir>``
  and reuses them there (``runtime/compile_cache.py``).

Differences from the JAX CLI: ``--device`` (default ``cuda``; with no card
and no ``--device=cpu`` it fails), checkpoints are the port's ``torch.save``
files (not JAX msgpack), the train sampler draws no example batch before
training (torch needs no shapes to build a model), ``--export`` with another
family than ``av`` is refused (JAX ignores it), and ``decode.quantize`` is
read by the flagship's ``--infer`` and the streams only, a ``torchrun`` launch
builds a mesh whatever its world size (a ``(1, 1)`` one on one rank; JAX
builds none for one device), and only rank 0 writes files of the file layout
and the CSV logs.
"""

from __future__ import annotations

import json
import os
import sys

FAMILIES = ("av", "audio", "visual", "ssl")


def build_data(cfg, tokenizer, synthetic: bool, device="cuda", device_put: bool = True):
    """``(train_factory, val_factory)``, each returning an epoch's batches.
    Processed batches are placed on ``device`` by the prefetch thread when
    ``device_put``; raw batches are preprocessed on ``device``."""
    from .data.collate import collate_pairs_raw, make_bucket_specs
    from .data.device_pipeline import device_preprocessed_batches
    from .data.manifest import build_data_list, train_val_test_split
    from .data.pairs import FixedPairSampler, RandomPairSampler, generate_fixed_pairs
    from .data.pipeline import (
        FilePairSource,
        PrefetchingLoader,
        SyntheticPairSource,
        bucketed_batches,
    )

    specs = make_bucket_specs(cfg.data.video_buckets, cfg.data.audio_samples_per_video_frame,
                              cfg.data.max_label_len)
    put = device if device_put else None

    if synthetic:
        def synthetic_factory(src, n_pairs, batch_size):
            def factory():
                it = (src.load_pair() for _ in range(n_pairs))
                return PrefetchingLoader(lambda: bucketed_batches(it, specs, batch_size),
                                         depth=cfg.data.prefetch_depth, device=put)
            return factory

        return (synthetic_factory(SyntheticPairSource(tokenizer, seed=cfg.data.seed),
                                  cfg.data.num_pairs_per_epoch, cfg.train.batch_size),
                synthetic_factory(SyntheticPairSource(tokenizer, seed=cfg.data.seed + 1),
                                  cfg.data.eval_pairs, cfg.train.eval_batch_size))

    entries, skipped = build_data_list(cfg.data.json_folder, cfg.data.npy_dir,
                                       cfg.data.text_dir, cfg.data.wav_dir)
    if skipped:
        print(f"manifest: skipped {len(skipped)} sentences with missing artifacts")
    if len(entries) < 2:
        raise SystemExit("no usable data found (the bundled corpus is metadata-only); "
                         "run with --synthetic or point data.* config at a prepared dataset")
    train_set, val_set, _ = train_val_test_split(entries, seed=cfg.data.seed)
    source = FilePairSource(tokenizer, cfg.data.sample_rate)
    on_device = cfg.data.device_preprocess
    load_fn = source.load_pair_raw if on_device else source.load_pair
    train_sampler = RandomPairSampler(train_set, load_fn, cfg.data.num_pairs_per_epoch,
                                      seed=cfg.data.seed)
    val_sampler = FixedPairSampler(
        generate_fixed_pairs(val_set, cfg.data.eval_pairs, seed=cfg.data.seed), load_fn)

    def make_factory(sampler, batch_size):
        if on_device:
            def factory():
                loader = PrefetchingLoader(
                    lambda: bucketed_batches(iter(sampler), specs, batch_size,
                                             collate_fn=collate_pairs_raw),
                    depth=cfg.data.prefetch_depth)
                return device_preprocessed_batches(loader, device=device)
            return factory

        def factory():
            return PrefetchingLoader(lambda: bucketed_batches(iter(sampler), specs, batch_size),
                                     depth=cfg.data.prefetch_depth, device=put)
        return factory

    return (make_factory(train_sampler, cfg.train.batch_size),
            make_factory(val_sampler, cfg.train.eval_batch_size))


def _checkpoint(cfg) -> str:
    """``best_wer.ckpt``, else ``last.ckpt``, under ``train.checkpoint_dir``."""
    for name in ("best_wer.ckpt", "last.ckpt"):
        path = os.path.join(cfg.train.checkpoint_dir, name)
        if os.path.isfile(path):
            return path
    raise SystemExit(f"no checkpoint under {cfg.train.checkpoint_dir}")


def run_infer(cfg, tokenizer, synthetic: bool, device="cuda", export_dir: str = "") -> None:
    """``--infer``: the checkpoint's transcripts of the eval pairs.  With
    ``--export=<dir>``, the serving computation is first exported at the
    first eval batch's shapes (``infer.export_transcriber``)."""
    from .infer import Transcriber, export_transcriber

    _, val_factory = build_data(cfg, tokenizer, synthetic, device, device_put=False)
    ckpt = _checkpoint(cfg)
    transcriber = Transcriber.from_checkpoint(cfg, tokenizer, ckpt, device=device,
                                              quantize=cfg.decode.quantize)
    if cfg.decode.quantize:
        print(f"int8 weight-only serving: {transcriber.forward.nbytes / 1e6:.1f} MB of "
              "parameters")
    if export_dir:
        batches = iter(val_factory())
        first = next(batches)
        batches.close()
        report = export_transcriber(transcriber, export_dir, first)
        print(f"exported serving artifact to {export_dir} ({report['nodes']} graph nodes, "
              f"{report['bytes'] / 1e6:.1f} MB, traced in {report['seconds']:.1f} s)")
    print(f"transcribing with {ckpt}")
    n = 0
    for batch in val_factory():
        texts = transcriber.transcribe(batch)
        for t1, t2 in texts[: int(batch.get("num_real", len(texts)))]:
            print(f"[utt {n}] speaker1: {t1}")
            print(f"[utt {n}] speaker2: {t2}")
            n += 1
    print(f"transcribed {n} pairs")


def run_eval(cfg, tokenizer, synthetic: bool, device="cuda") -> None:
    """``--eval``: eval-split loss, WER and CER of the checkpoint, greedy and
    by ``decode.algorithm``, as one JSON line."""
    from .config import torch_dtype
    from .models import build_av_model
    from .train import MultiSpeakerTrainer
    from .train.checkpoints import restore_checkpoint

    _, val_factory = build_data(cfg, tokenizer, synthetic, device, device_put=False)
    ckpt = _checkpoint(cfg)
    trainer = MultiSpeakerTrainer(cfg, build_av_model(cfg.model, torch_dtype(cfg.model.dtype)),
                                  tokenizer, device=device)
    state = trainer.init_state(cfg.data.seed)
    payload = restore_checkpoint(ckpt, template={"state": state, "epoch": 0})
    report = {"checkpoint": ckpt, "epoch": int(payload.get("epoch", 0)), "decode": {}}
    for name, use_beam in (("greedy", False), (cfg.decode.algorithm, True)):
        loss, wer, cer, _ = trainer.evaluate(val_factory(), state, use_beam=use_beam)
        report["decode"][name] = {"eval_loss": round(float(loss), 4),
                                  "wer": round(float(wer), 4), "cer": round(float(cer), 4)}
        print(f"[eval] {name}: loss={loss:.4f} wer={wer:.4f} cer={cer:.4f}", flush=True)
    print(json.dumps(report))


def run_stream_av(cfg, tokenizer, paths: list[str], device="cuda") -> None:
    """``--stream=lips1.avi,lips2.avi,mix.wav``: AVI decode, host lip
    preprocessing and the flagship streamed with a carried decode per
    speaker; chunk and context are ``decode.stream_*_seconds`` in video
    frames."""
    from .config import torch_dtype
    from .data.audio_io import load_audio
    from .data.avi import read_avi
    from .data.pipeline import preprocess_lip_clip_host
    from .infer import load_weights
    from .models import MultiSpeakerAVModel
    from .streaming import StreamingAVTranscriber

    if len(paths) != 3:
        raise SystemExit("--stream AV mode takes lips1.avi,lips2.avi,mix.wav")
    lips_path1, lips_path2, wav_path = paths
    ckpt = _checkpoint(cfg)
    model = load_weights(MultiSpeakerAVModel(cfg.model, torch_dtype(cfg.model.dtype)), ckpt)
    spf = cfg.data.audio_samples_per_video_frame
    fps = cfg.data.sample_rate / spf
    s = StreamingAVTranscriber(
        cfg, tokenizer, model, device=device,
        chunk_frames=max(1, round(cfg.decode.stream_chunk_seconds * fps)),
        context_frames=max(1, round(cfg.decode.stream_context_seconds * fps)))

    lips1 = preprocess_lip_clip_host(read_avi(lips_path1)[0], s.lip_size)
    lips2 = preprocess_lip_clip_host(read_avi(lips_path2)[0], s.lip_size)
    audio = load_audio(wav_path, cfg.data.sample_rate)
    block_f = s.chunk_frames
    n_f = min(lips1.shape[0], lips2.shape[0], len(audio) // spf)
    print(f"streaming AV {lips_path1}+{lips_path2}+{wav_path} ({n_f} frames) with {ckpt}, "
          f"chunk={block_f} frames")

    def show(t1, t2):
        if t1:
            print(f"[speaker1] {t1}", flush=True)
        if t2:
            print(f"[speaker2] {t2}", flush=True)
    for i in range(0, n_f, block_f):
        j = min(i + block_f, n_f)
        show(*s.feed(lips1[i:j], lips2[i:j], audio[i * spf:j * spf]))
    show(*s.flush())


def run_stream(cfg, tokenizer, spec: str, device="cuda") -> None:
    """``--stream``: one WAV through ``StreamingAudioTranscriber``, several
    (comma-separated) as concurrent streams of one ``StreamingPool``, or
    ``lips1.avi,lips2.avi,mix.wav`` through ``run_stream_av``."""
    from .config import torch_dtype
    from .data.audio_io import load_audio
    from .infer import load_weights
    from .models import AudioOnlyCTC
    from .streaming import StreamingAudioTranscriber, StreamingPool

    paths = [p for p in spec.split(",") if p]
    if any(p.lower().endswith(".avi") for p in paths):
        return run_stream_av(cfg, tokenizer, paths, device)
    ckpt = _checkpoint(cfg)
    model = load_weights(AudioOnlyCTC(cfg.model, torch_dtype(cfg.model.dtype)), ckpt)
    kw = dict(chunk_seconds=cfg.decode.stream_chunk_seconds,
              context_seconds=cfg.decode.stream_context_seconds, device=device,
              quantize=cfg.decode.quantize)
    if len(paths) > 1:
        s = StreamingPool(cfg, tokenizer, model, max_streams=len(paths), **kw)
    else:
        s = StreamingAudioTranscriber(cfg, tokenizer, model, **kw)

    block = s.chunk_samples
    if len(paths) > 1:
        audios = [load_audio(p, cfg.data.sample_rate) for p in paths]
        sids = [s.open() for _ in paths]
        print(f"streaming {len(paths)} concurrent files with {ckpt}, "
              f"chunk={block / cfg.data.sample_rate:.1f}s", flush=True)
        for i in range(0, max(a.shape[0] for a in audios), block):
            for sid, audio in zip(sids, audios):
                if i < audio.shape[0]:
                    piece = s.feed(sid, audio[i:i + block])
                    if piece:
                        print(f"[{paths[sid]}] {piece}", flush=True)
        for sid, path in zip(sids, paths):
            tail = s.flush(sid)
            if tail:
                print(f"[{path}] {tail}", flush=True)
        return

    audio = load_audio(paths[0], cfg.data.sample_rate)
    print(f"streaming {paths[0]} ({audio.shape[0] / cfg.data.sample_rate:.1f} s) with {ckpt}, "
          f"chunk={block / cfg.data.sample_rate:.1f}s")
    for i in range(0, audio.shape[0], block):
        piece = s.feed(audio[i:i + block])
        if piece:
            print(piece, flush=True)
    tail = s.flush()
    if tail:
        print(tail, flush=True)


def run_ssl_pretrain(cfg, tokenizer, synthetic: bool, device="cuda") -> None:
    """``--family=ssl`` (``main.py:393-441``): masked-span InfoNCE over the
    flagship's batches (with ``data.device_preprocess``, K2 x2 per batch),
    whole-state resume, spans seeded per epoch, a SIGTERM saving the
    previous epoch.  ``last.ckpt``'s audio encoder grafts into the flagship
    through ``train.audio_init_ckpt``."""
    import numpy as np

    from .train.checkpoints import CheckpointManager, save_checkpoint
    from .train.preempt import GracefulShutdown
    from .train.ssl_pretrain import MaskedAudioPretrainer

    train_factory, _ = build_data(cfg, tokenizer, synthetic, device, device_put=False)
    ssl = MaskedAudioPretrainer(cfg, mask_prob=cfg.train.ssl_mask_prob,
                                span=cfg.train.ssl_mask_span,
                                temperature=cfg.train.ssl_temperature, device=device)
    state = ssl.init_state(cfg.data.seed)
    ckpts = CheckpointManager(cfg.train.checkpoint_dir)
    resumed = ckpts.try_resume(template={"state": state, "epoch": 0})
    start_epoch = 1
    if resumed is not None:
        start_epoch = int(resumed["epoch"]) + 1
        print(f"resuming ssl from {ckpts.last} at epoch {start_epoch}")
    with GracefulShutdown(enable=cfg.train.handle_signals) as stop:
        for epoch in range(start_epoch, cfg.train.max_epochs + 1):
            state, last_loss = ssl.fit(
                state, train_factory(), log_every=cfg.train.log_every,
                span_rng=np.random.default_rng(cfg.data.seed * 1009 + epoch), stop=stop)
            if stop.requested:
                save_checkpoint(ckpts.last, {"state": state, "epoch": epoch - 1})
                print(f"preempted: saved {ckpts.last} mid-epoch {epoch} "
                      f"(resume will redo the epoch)")
                break
            print(f"[ssl epoch {epoch}] infonce={last_loss:.4f}")
            save_checkpoint(ckpts.last, {"state": state, "epoch": epoch})


def build_single_modality_data(cfg, tokenizer, family: str, synthetic: bool):
    """``(train_factory, val_factory)`` of single-utterance batches for the
    ``audio`` or ``visual`` family (``main.py:444-478``), on the host."""
    from .data.manifest import build_data_list, train_val_test_split
    from .train.single_modality import (
        synthetic_audio_batches,
        synthetic_visual_batches,
        utterance_batches,
    )

    if synthetic:
        syn = synthetic_audio_batches if family == "audio" else synthetic_visual_batches
        n_train = max(1, cfg.data.num_pairs_per_epoch // cfg.train.batch_size)
        n_val = max(1, cfg.data.eval_pairs // cfg.train.eval_batch_size)
        return (lambda: syn(tokenizer, cfg.train.batch_size, n_train, seed=cfg.data.seed),
                lambda: syn(tokenizer, cfg.train.eval_batch_size, n_val,
                            seed=cfg.data.seed + 1))
    entries, _ = build_data_list(cfg.data.json_folder, cfg.data.npy_dir, cfg.data.text_dir,
                                 cfg.data.wav_dir)
    if not entries:
        raise SystemExit("no usable data; use --synthetic")
    train_set, val_set, _ = train_val_test_split(entries, seed=cfg.data.seed)
    return (lambda: utterance_batches(train_set, tokenizer, family, cfg.train.batch_size,
                                      cfg.data.sample_rate),
            lambda: utterance_batches(val_set, tokenizer, family, cfg.train.eval_batch_size,
                                      cfg.data.sample_rate, drop_last=False))


def _family_trainer(cfg, tokenizer, family: str, device):
    from .train.single_modality import make_audio_trainer, make_visual_trainer

    make = make_audio_trainer if family == "audio" else make_visual_trainer
    return make(cfg, tokenizer, device=device)


def _restore_single_modality(cfg, tokenizer, family: str, device="cuda"):
    """The family's trainer and its checkpoint (``best_wer.ckpt``, else
    ``last.ckpt``) restored into a state (``main.py:481-500``) -> ``(trainer,
    state, path, epoch)``."""
    from .train.checkpoints import restore_checkpoint

    ckpt = _checkpoint(cfg)
    trainer = _family_trainer(cfg, tokenizer, family, device)
    state = trainer.init_state(cfg.data.seed)
    payload = restore_checkpoint(ckpt, template={"state": state, "epoch": 0})
    return trainer, state, ckpt, int(payload.get("epoch", 0))


def run_eval_single_modality(cfg, tokenizer, family: str, synthetic: bool,
                             device="cuda") -> None:
    """``--eval --family=audio|visual`` (``main.py:503-523``): greedy and
    ``decode.algorithm`` scores of the checkpoint, one JSON line."""
    _, val_factory = build_single_modality_data(cfg, tokenizer, family, synthetic)
    trainer, state, ckpt, epoch = _restore_single_modality(cfg, tokenizer, family, device)
    report = {"checkpoint": ckpt, "family": family, "epoch": epoch, "decode": {}}
    for name, use_beam in (("greedy", False), (cfg.decode.algorithm, True)):
        loss, wer, cer = trainer.evaluate(val_factory(), state, use_beam=use_beam)
        report["decode"][name] = {"eval_loss": round(float(loss), 4),
                                  "wer": round(float(wer), 4), "cer": round(float(cer), 4)}
        print(f"[eval {family}] {name}: loss={loss:.4f} wer={wer:.4f} cer={cer:.4f}",
              flush=True)
    print(json.dumps(report))


def run_infer_single_modality(cfg, tokenizer, family: str, synthetic: bool,
                              device="cuda") -> None:
    """``--infer --family=audio|visual`` (``main.py:526-546``): the
    checkpoint's transcript of each eval utterance by ``decode.algorithm``."""
    from .infer import decode_ids

    _, val_factory = build_single_modality_data(cfg, tokenizer, family, synthetic)
    trainer, state, ckpt, _ = _restore_single_modality(cfg, tokenizer, family, device)
    print(f"transcribing ({family}) with {ckpt}")
    n = 0
    for batch in val_factory():
        lp, il = trainer.eval_forward(state, batch["inputs"], batch["meta"])
        ids, lens = decode_ids(cfg, lp, il, True, trainer.lm)
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        for b in range(int(batch.get("num_real", ids.shape[0]))):
            print(f"[utt {n}] {tokenizer.decode(ids[b, : lens[b]].tolist())}")
            n += 1
    print(f"transcribed {n} utterances")


def run_single_modality(cfg, tokenizer, family: str, synthetic: bool, device="cuda") -> None:
    """``--family=audio|visual`` training (``main.py:549-575``), resuming
    ``last.ckpt`` with its whole state."""
    from .train.checkpoints import CheckpointManager

    trainer = _family_trainer(cfg, tokenizer, family, device)
    train_factory, val_factory = build_single_modality_data(cfg, tokenizer, family, synthetic)
    state = trainer.init_state(cfg.data.seed)
    ckpts = CheckpointManager(cfg.train.checkpoint_dir, layout=cfg.train.checkpoint_layout)
    resumed = ckpts.try_resume(template={"state": state, "epoch": 0})
    start_epoch = 1
    if resumed is not None:
        start_epoch = int(resumed["epoch"]) + 1
        print(f"resuming from {ckpts.last} at epoch {start_epoch}")
    trainer.fit(state, train_factory, val_factory, start_epoch=start_epoch)


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {a for a in argv if a in ("--synthetic", "--infer", "--eval")}
    device, stream, export_dir, family, overrides = "cuda", None, "", "av", []
    for a in argv:
        if a in flags:
            continue
        name, _, value = a.partition("=")
        if name == "--device":
            device = value
        elif name == "--stream":
            stream = value
        elif name == "--export":
            export_dir = value
        elif name == "--family":
            family = value
        elif a.startswith("--"):
            raise SystemExit(f"unknown flag {a}")
        else:
            overrides.append(a)
    if family not in FAMILIES:
        raise SystemExit(f"--family must be av|audio|visual|ssl, got {family}")
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {device!r}")
    if export_dir and "--infer" not in flags:
        raise SystemExit("--export=<dir> exports the serving computation of --infer; "
                         "pass --infer with it")
    if export_dir and family != "av":
        raise SystemExit("--export=<dir> exports the flagship's serving computation; "
                         f"--family={family} has none")

    import torch

    from .config import from_flat_overrides
    from .text import CharTokenizer

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port runs on the card; pass --device=cpu "
                         "to run on the CPU")
    cfg = from_flat_overrides(overrides)
    if cfg.model.arch != "flagship" and (stream is not None or family != "av" or export_dir
                                         or cfg.decode.quantize):
        raise SystemExit(f"model.arch={cfg.model.arch} trains, evaluates (--eval) and "
                         "transcribes (--infer); --stream, --export, --family and "
                         "decode.quantize serve the flagship")
    if cfg.compile_cache_dir:
        from .runtime.compile_cache import enable_compile_cache

        enable_compile_cache(cfg.compile_cache_dir)

    vocab = cfg.data.vocab_path
    if not os.path.exists(vocab):
        vocab = os.path.join(os.path.dirname(__file__), "..", "assets", "tokenizer800.vocab")
    tokenizer = CharTokenizer(vocab)
    cfg.model.decoder.vocab_size = tokenizer.vocab_size
    synthetic = "--synthetic" in flags

    if stream is not None:
        run_stream(cfg, tokenizer, stream, device)
        return
    if "--eval" in flags:
        if family == "ssl":
            raise SystemExit("--eval scores decoder-bearing families (av|audio|visual); "
                             "finetune an SSL checkpoint first (train.audio_init_ckpt)")
        if family == "av":
            run_eval(cfg, tokenizer, synthetic, device)
        else:
            run_eval_single_modality(cfg, tokenizer, family, synthetic, device)
        return
    if "--infer" in flags:
        if family == "ssl":
            raise SystemExit("--infer serves decoder-bearing families (av|audio|visual)")
        if family == "av":
            run_infer(cfg, tokenizer, synthetic, device, export_dir)
        else:
            run_infer_single_modality(cfg, tokenizer, family, synthetic, device)
        return
    if family == "ssl":
        run_ssl_pretrain(cfg, tokenizer, synthetic, device)
        return
    if family != "av":
        run_single_modality(cfg, tokenizer, family, synthetic, device)
        return
    from .parallel import initialize_distributed

    launched = initialize_distributed(device)
    try:
        run_train(cfg, tokenizer, synthetic, device, launched)
    finally:
        if launched:
            torch.distributed.destroy_process_group()


def _graft(state, source: dict, prefix: str) -> None:
    """Copy ``source``'s tensors under ``prefix`` into the state's model in
    place (whole or split over a mesh)."""
    from .parallel import copy_into
    from .train.checkpoints import graft_subtree

    own = state.model.state_dict()
    for k, v in graft_subtree(own, source, [prefix]).items():
        if v is not own[k]:
            copy_into(own[k], v)


def run_train(cfg, tokenizer, synthetic: bool, device="cuda", launched: bool = False) -> None:
    """Train the flagship (``main.py:652-752``); ``launched``: a process
    group is up (``torchrun``), so over a mesh of its ranks."""
    import torch

    from .config import torch_dtype
    from .models import build_av_model
    from .train import MultiSpeakerTrainer
    from .train.checkpoints import CheckpointManager, restore_checkpoint
    from .train.ssl_pretrain import flagship_audio_params

    mesh = None
    if launched:
        from .parallel import make_hybrid_mesh, process_local_batch_size

        world = torch.distributed.get_world_size()
        mp = cfg.mesh.model_axis
        if cfg.mesh.data_axis not in (-1, world // mp) or world % mp:
            raise SystemExit(f"mesh.data_axis={cfg.mesh.data_axis} x mesh.model_axis={mp} "
                             f"does not cover the {world} ranks")
        mesh = make_hybrid_mesh(mp, device_type=device)
        print(f"mesh: {mesh}")
        cfg.train.batch_size = process_local_batch_size(cfg.train.batch_size, mp)
        cfg.train.eval_batch_size = process_local_batch_size(cfg.train.eval_batch_size, mp)
        print(f"process {torch.distributed.get_rank()}: local batch "
              f"{cfg.train.batch_size} (train) / {cfg.train.eval_batch_size} (eval)")

    ckpts = CheckpointManager(cfg.train.checkpoint_dir, layout=cfg.train.checkpoint_layout)
    model = build_av_model(cfg.model, torch_dtype(cfg.model.dtype))
    frozen = ("visual_encoder",) if cfg.train.freeze_visual_trunk else ()
    trainer = MultiSpeakerTrainer(cfg, model, tokenizer, frozen_prefixes=frozen, device=device,
                                  mesh=mesh, fsdp=mesh is not None and cfg.mesh.fsdp)
    train_factory, val_factory = build_data(cfg, tokenizer, synthetic, device)
    state = trainer.init_state(cfg.data.seed)

    if cfg.train.visual_init_ckpt:
        src = restore_checkpoint(cfg.train.visual_init_ckpt)
        src_state = src.get("state", src)
        _graft(state, src_state.get("model", src_state), "visual_encoder")
        print(f"grafted visual encoder from {cfg.train.visual_init_ckpt}")
    if cfg.train.audio_init_ckpt:
        src = restore_checkpoint(cfg.train.audio_init_ckpt)
        src_state = src.get("state", src)
        _graft(state, flagship_audio_params(src_state.get("model", src_state)), "audio_encoder")
        print(f"grafted audio encoder from {cfg.train.audio_init_ckpt}")

    fresh_dropout = state.generator.get_state()
    resumed = ckpts.try_resume(template={"state": state, "epoch": 0})
    start_epoch = 1
    if resumed is not None:
        start_epoch = int(resumed["epoch"]) + 1
        print(f"resuming from {ckpts.last} at epoch {start_epoch}")
        state.generator.set_state(fresh_dropout)

    trainer.fit(state, train_factory, val_factory, start_epoch=start_epoch)


if __name__ == "__main__":
    main()
