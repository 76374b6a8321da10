"""Smoke run of the PyTorch port's serving surface, serving export, training step,
training run, the audio-only, visual-only, SSL and legacy families, the reference
checkpoint import, offline lip extraction, the runtime tools, the meshed
training path, the long-form encoder, the Conformer pipeline, the double audio
pass and the raw-media corpus on one NVIDIA GPU (H100).

    python3 chip_smoke.py      # needs one CUDA card; a few minutes on an H100

Phases, each printing a line; any failure exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, TF32 settings (both off);
2. build: ``nvcc`` for every kernel source in ``multimodal_av_model_tpu_torch/csrc``,
   all started together;
3. K1 (log-mel), K2 (lip preprocess), K3 (prefix beam) and K4 (the BiLSTM
   recurrence, forward and backward, at a request's and a ``train_b8`` step's
   rows) at their main paths' shapes: each kernel against its plain PyTorch
   version on the same inputs (K4: no further from the f64 loop than the bf16
   plain loop),
   with the stated tolerance, then timed by CUDA events around a CUDA graph of back-to-back
   launches (the ``ms`` of the ``kernels`` JSON) and around launches issued
   one by one (the host's rate), beside its plain version, a library
   yardstick and its bound;
4. reference: the whole path at a small width in f32, on the card (kernels)
   and on the CPU (plain versions), log-probs compared and the decoder's ids
   held exactly;
5. serving: the flagship at full width (12x512 Conformer, ResNet-18, fusion 512,
   2-layer BiLSTM, vocab 800, bf16, seeded random weights): three requests of
   4 pairs at bucket 128 and one at bucket 64, each through
   ``preprocess_batch_device`` -> ``Transcriber.transcribe`` (prefix beam 5,
   top-k 8), with launch counts read just after;
6. each kernel's own device time per launch, read by ``torch.profiler``
   (CUPTI) over launches issued one by one at the shapes of phase 3 (after
   the timed requests, and in the process's first profiler session, which
   catches every launch);
7. outside the counted run, one more request with the port's recorder on
   (``tracing``: host and device ms and host syncs of each span);
8. ``[train-ref]`` (run after phase 5): one training step of a small f32
   model (BatchNorm, no dropout, B = 2, bucket 64) from one seeded state on
   the card (K1, K2) and on the CPU (plain versions), on the same raw batch:
   loss, ``grad_norm``, every gradient and the BatchNorm statistics compared;
9. ``[train]`` (after phase 8): the flagship training step at the shipped
   defaults (bf16 compute, f32 parameters, BatchNorm, PReLU, dropout 0.1) on
   ``bench.py``'s shapes (clips of 120 frames, labels of 20 tokens, uint8
   128x128x3 crops at bucket 128), raw batch -> ``device_preprocessed_batches``
   -> ``MultiSpeakerTrainer.train_step``: B = 8 without recomputation (2
   warm-up and 10 timed steps) and B = 32 with ``visual.remat="frontend"`` (2
   and 5), launch counts read around the timed steps, FLOPs per step by
   ``FlopCounterMode``, utt/s as all the utterances over all the timed
   steps' time; before each size's steps, K1 and K2 against their plain
   versions (phase 3's bars) at the shapes that size gives them;
10. ``[fit]`` (after phase 9): the training run through the port's CLI at the
    same full width, on a corpus written to a temporary directory in the
    AI-Hub layout (8 speakers x 6 sentences of 3.0-4.2 s: 48 kHz wavs, uint8
    128x128x3 crops, texts, JSON): ``main`` trains 2 epochs (B = 8, 32 pairs
    an epoch, 8 eval pairs at B = 4, asynchronous checkpoints), resumes to
    epoch 3, then ``--eval``, ``--infer``, one ``--synthetic`` epoch of 16
    pairs and one epoch of 128 pairs from disk in a fresh directory.  It
    prints each call's seconds, peak memory and launches (K1 1 and K2 2 per
    train step, eval batch and infer batch; K2 0 on ``--synthetic``), and
    per epoch the losses, utt/s and the time the step loop waited for its
    input, split into the first batch and the others; it checks finite
    losses, 3 rows of
    ``eval_log.csv``, ``last.ckpt`` at epoch 3, the ``--eval`` JSON and 8
    transcribed pairs;
11. ``[train-profile]`` (after phase 7): one B = 8 step with the
    recorder on;
12. ``[beam-ref]`` (after phase 5): ``decode.algorithm="reference_beam"`` on
    one bucket-128 request; the card's ids equal a CPU run of the reference
    beam on the same log-probs, and the decode's ms;
13. ``[quant]``: the int8 ``Transcriber`` (``decode.quantize``) on phase 5's
    requests: every dequantized tensor equal to the plain dequantization on
    the CPU, K1 1 and K2 2 per request; bytes held against the fp copy,
    latency, peak memory, and the share of ids equal to the fp
    ``Transcriber``'s (reported);
14. ``[stream-ref]``: the pairing gates in f32 at a small width (three pooled
    streams equal three single-stream runs, every ``AudioService`` answer a
    direct transcription);
15. ``[stream-audio]``: ``AudioOnlyCTC`` on the flagship's 12x512 Conformer
    (vocab 800, bf16): K1 against its plain version at ``[1, 160000]`` and
    ``[8, 160000]``; 30 s through ``StreamingAudioTranscriber`` in 2 s chunks
    over 8 s of context (prefix beam), then 8 streams of 20 s through a
    ``StreamingPool``: 1 K1 per window or tick, finite normalised log-probs,
    per-chunk latency, the real-time factor and peak memory;
16. ``[serve]``: ``AudioService(max_batch=8, max_seconds=16)`` over the same
    model with 32 requests from threads: K1 at ``[8, 256000]``, every request
    answered, mean batch, latency p50 and p90, peak memory; K3 against the
    plain loop on one full batch's ``[8, 801, 800]`` log-probs;
17. ``[stream-av]``: the CLI ``--stream=lips1.avi,lips2.avi,mix.wav`` on a
    full-width flagship checkpoint and 12 s of media that the port writes:
    K1 at the window's ``[1, 160200]``, K1 1 and K2 0 per window, each
    speaker's streamed prefix-beam ids equal to one offline pass over the
    emitted log-probs, and each of K3's steps on the carried state equal to
    the plain loop's on the same state and log-probs; per-window ms and the
    real-time factor.

18. ``[export]`` (after phase 10): phase 5's ``Transcriber`` exported by
    ``export_transcriber`` (``torch.export`` of the forward with K1 as the
    operator ``mmav::log_mel`` and the prefix beam, at bucket 128, B = 4) and
    its int8 form with greedy decoding; each artifact loaded by
    ``ExportedTranscriber.load`` and run on phase 5's three bucket-128
    requests after ``preprocess_batch_device`` (K2 x2): ids equal to the
    ``Transcriber``'s, K1 once and K2 never inside an artifact call; the
    export's seconds and graph nodes, the artifact's MB, the load's seconds
    and the per-request ms beside ``[serving]``'s;
19. ``[temporal-tf]``: the flagship with ``fusion.temporal_model=
    "transformer"`` (2 layers, 8 heads, FFN 2048): phase 4's small f32 check
    with it, three bucket-128 requests (K1 1, K2 2 each), one more timed by
    layer, and B = 8 training steps at ``bench.py``'s shapes (2 warm-up, 5
    timed) as phase 9 runs them;
20. ``[structured]``: a small AI-Hub corpus written to a temporary directory,
    ``validate_manifest`` on it with one lip file corrupted on purpose (it
    must be skipped as unreadable), its sentences read back by
    ``load_reference_sentences``, then the transformer flagship trained 20
    steps at B = 8 on ``RealTextStructuredSource`` batches (K1 1, K2 0 per
    step), the first and last loss and the ``nearest_centroid_probe``
    accuracy on overlap against solo frames.

21. ``[family-ref]``: one training step of each family's small f32 model
    (dropout 0, B = 2): the audio family (K1), the visual family (BatchNorm)
    and the SSL pretrainer (the same spans), each on the card and on the CPU
    from one seeded state: loss, every gradient and the BatchNorm statistics
    at phase 8's bars; SpecAugment's apply on the card equal to the CPU's
    with the same draws;
22. ``[family-audio]``: ``AudioOnlyCTC`` at full width (12x512 Conformer,
    800 tokens, f32 as the JAX CLI builds it) at ``utterance_batches``'
    ``[8, 160000]``: K1 against its plain version there, 2 warm-up and 10
    timed ``train_step``s (K1 1, K2 0 per step; ms, utt/s, peak memory,
    ``mfu``), then 3 steps with SpecAugment on;
23. ``[family-visual]``: ``VisualOnlyCTC`` at full width (ResNet-18,
    BatchNorm, PReLU) on ``[8, 448, 1, 96, 96]`` host lips, timed as phase
    22 (no kernel runs);
24. ``[ssl]``: on a corpus written as phase 10's, ``MaskedAudioPretrainer``
    at full width on ``build_data`` batches with ``device_preprocess`` (K1 1
    and K2 2 per step, both checked against their plain versions at the
    step's shapes), 2 warm-up and 10 timed steps, the InfoNCE falling;
25. ``[families-cli]``: the CLI on that corpus: ``--family=audio`` for 2
    epochs and a resume to 3, its ``--eval``, ``--infer`` and ``--stream``,
    ``--family=visual`` and ``--family=ssl`` for 1 epoch each, then one
    flagship epoch with ``train.audio_init_ckpt`` and
    ``train.visual_init_ckpt`` (both "grafted" lines), each call's seconds,
    peak memory and launches (K1 1 per audio-encoder forward; K2 2 per
    forward of the flagship and SSL, 0 elsewhere).
26. ``[legacy-ref]``: one step of a small f32 legacy model
    (``MultimodalCTCKoreanModel``, hidden 16, B = 2) from one seeded state
    on the card and on the CPU, at phase 21's bars;
27. ``[legacy]``: on a corpus written as phase 10's, 16 legacy sample
    directories by ``build_all_pair_samples``; K1 against its plain version
    at each mixture's ``[1, S]``; then the main path: ``load_legacy_sample``
    of each directory on the card (K1 once each, K2 never: the frames keep
    their colour and are resized on the host, as in JAX) and
    ``LegacyTrainer.fit`` at full width (hidden 256, 96x96x3, 11,173
    syllables, f32, B = 4, 3 epochs of 4 steps), each step timed, the loss
    of one held batch falling;
28. ``[reference-import]``: a full-width checkpoint in the upstream
    reference's layout with seeded tensors, imported by the port's CLI
    (``python -m multimodal_av_model_tpu_torch.compat.torch_import``), each
    mapped tensor equal to its source under the mapping and the rest kept
    from the template; then three bucket-128 requests served from the file
    by ``Transcriber.from_checkpoint`` (K1 1 and K2 2 each);
29. ``[lip-extract]``: two AVIs written by ``write_avi`` (a moving red lip
    on a face, 6 s of 320x240) and their AI-Hub JSONs through
    ``open_video`` and ``extract_clips`` with the default localizer, each
    box holding the drawn lips; K2 against its plain version at the clips'
    ``[T, 128, 128, 3]``; then three requests of the extracted clips and a
    mixture, served by phase 28's ``Transcriber`` (K1 1 and K2 2 each), and
    the extraction's frames per second (``--only=lip-extract`` runs phase 28
    too).
30. ``[hostops]`` (right after phase 2): the native host ops
    (``runtime/hostops.cpp``) built, ``have_native()``, and each op against
    its numpy path at the pipeline's shapes: 5 minutes of 48 kHz PCM decoded
    and resampled to 16 kHz, a 120-frame clip of 128x128 crops resized to
    96, the edit distances of 2,000 transcript pairs; native and numpy ms;
31. ``[dist]`` (after phase 29): a world-size-1 NCCL group
    (``tcp://127.0.0.1`` on a free port) and a (1, 1) mesh; the flagship at
    full width, B = 8 at ``bench.py``'s shapes, with ``fsdp=True``: K1 and K2
    against their plain versions at the step's shapes, one step against the
    unmeshed ``train_step`` from the same state (phase 8's bars), then 8
    timed steps of each (the meshed ones the main path: raw batch ->
    ``device_preprocessed_batches`` -> ``shard_batch`` -> the FSDP-wrapped
    forward and backward -> Adam; K1 1 and K2 2 a step), and a sharded
    checkpoint written, restored into a fresh meshed state and into the
    unmeshed one, tensors equal;
32. ``[dist-cli]``: ``torchrun --standalone --nproc-per-node=1`` of the CLI
    (``main.main``, through this script's ``--cli-child``, which counts the
    kernels' launches in that process) with ``mesh.fsdp=true
    train.checkpoint_layout=sharded`` on a corpus written as phase 10's: one
    epoch, a resume (``resuming from``), then one epoch with
    ``mesh.model_axis=1 mesh.fsdp=false``; seconds, peak memory, launches;
33. ``[runtime]`` (last, after every other profiler session): ``trace`` of
    one bucket-128 request of phase 5 with ``annotate`` ranges (the trace
    holds them, ``logmel_kernel`` and ``lip_kernel``), ``nan_guard`` on a
    request with a NaN in the mixture, ``device_memory_stats``, and the
    kernels and host ops built by two fresh processes under one
    ``compile_cache_dir`` (the second finds them).
34. ``[longform]`` (after phase 32): K1 against its plain version at a
    120 s and a 960 s stream (``[1, 1920000]``, ``[1, 15360000]``); then on a
    world-size-1 NCCL group the long-form encoder (``make_cp_audio_encoder``,
    the flagship's 12 x 512 Conformer in f32, seeded weights) with
    ``impl="ring"`` and ``impl="gather"`` against the full-attention
    ``AudioEncoder`` on the same parameters and a pad-free 120 s stream
    (6,001 encoder frames): ``last`` and ``middle`` at atol 2e-4, rtol 1e-4,
    ms per call and peak memory of each, K1 once per CP call;
35. ``[pp]``: on a world-size-1 NCCL group, the flagship's 12 Conformer
    blocks (f32, seeded) as one pipeline stage, ``pipeline_blocks`` with 4
    microbatches on B = 8 rows of 201 frames against the blocks applied in
    turn: forward within 2e-5, every parameter's gradient at rtol 5e-4 and
    atol 5e-5; the ms of a forward and backward of each, peak memory, no
    kernel launched;
36. ``[shared-pass]``: ``model.shared_audio_pass=false``, the double audio
    pass (the encoder on ``[2B]`` rows, each under its own speaker's mask,
    K1 once on ``[2B, S]``): phase 4's small f32 check of the double pass,
    card against CPU and against the shared pass with the same parameters
    (log-probs, exact prefix-beam ids); at full width K1 against its plain
    version at ``[8, 68352]`` and ``[16, 68352]``, one bucket-128 request of
    4 mixtures served with the double pass (K1 1, K2 2), and the B = 8 step
    at ``bench.py``'s shapes, 2 warm-up steps of each pass, then 5 timed
    steps of each in turns, shared, double, double, shared (K1 1, K2 2 a
    step): step times, utt/s, peak memory, FLOPs a step and the audio
    encoder's forward FLOPs (``FlopCounterMode``; they must double);
37. ``[raw-media]``: the port's ``write_raw_media_corpus`` (4 videos x 4
    sentences of 2 s, 320x240 AVIs at 30 fps, 48 kHz stereo WAVs; about 270
    MB), ``extract_clips`` of 128x128x3 crops from the precomputed boxes,
    ``save_all_sentence_labels`` and ``build_data_list``; K1 and K2 against
    their plain versions at these clips' shapes; then 3 flagship steps at
    full width on B = 8 speaker-distinct pairs each, through
    ``load_pair_raw`` -> ``collate_pairs_raw`` ->
    ``device_preprocessed_batches`` (K1 1 and K2 2 a step); the write,
    extraction and step seconds.
38. ``[whisper-flamingo]``: ``model.arch=whisper_flamingo`` with its widths
    cut (2 + 2 Whisper layers of 256, a 2-layer video encoder of 256) at
    the benchmark cell's K1 and K2 shapes: B = 16 mixtures padded to
    Whisper's 30 s window (``[16, 480000]``, 80 Slaney bins) and
    ``[16, 256]`` clips of 128x128x3 crops to 88x88; after a warm-up step,
    one pull of a batch through ``device_preprocessed_batches`` with
    ``pipeline_options`` and its ``train_step`` launch K1 once and K2 twice,
    and K1 in Slaney mode with ``whisper_log_mel`` after it holds to its
    plain version on that step's mixture (rtol 2e-3 and atol 1e-2 on the
    mel power, rtol = atol = 2e-3 on the features).

The ``launches`` of the ``kernels`` JSON add the serving requests of phase 5,
the timed training steps of phase 9, the CLI calls of phase 10 and the main
paths of phases 13, 15-17, 18-20, 22-25, 27-29, 31, 32 and 34-38 (each
path's own count is under ``launches_by_path``, K3's and K4's as K1's and
K2's).
``--only=`` with some of ``k3``, ``k4``, ``family-ref``, ``family-audio``,
``family-visual``, ``families``, ``legacy-ref``, ``legacy``, ``reference-import``, ``lip-extract``,
``hostops``, ``runtime`` (which runs phase 5 first), ``dist``, ``dist-cli``,
``longform``, ``pp``, ``shared-pass``, ``raw-media`` and ``whisper-flamingo`` runs the card and
build lines and those phases alone
(a rehearsal: no kernels JSON, no result line).  The last three lines are the
``kernels`` JSON, the ``nvidia-smi`` line and ``{"ok": true, "device":
...}``.  Nothing of JAX is imported.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, dense
# TF32 on the tensor cores, HBM3.  f32-accurate products on the tensor cores
# take three TF32 passes (3xTF32), so they run at a third of the TF32 peak.
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
# Dense bf16 on the tensor cores, the same data sheet: the `mfu` of [train].
PEAK_BF16_FLOPS = 989e12


def log(msg: str) -> None:
    print(msg, flush=True)


def add_launches(total: dict, more) -> dict:
    """``total`` with ``more``, the K1, K2, K3 and K4 launches in the order of
    ``ops.launch_counts``, added."""
    return {k: n + m for (k, n), m in zip(total.items(), more)}


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, inputs, iters: int, graph: bool = False) -> float:
    """Mean time of ``fn(*inputs[i % len])`` over ``iters`` calls, after a
    warm-up, by CUDA events.  Called eagerly, the calls are timed as the host
    issues them: where the host takes longer to issue a call than the device
    to run it, that is the host's time.  With ``graph``, the ``iters`` calls
    are captured once in a CUDA graph and the events time its replay: the
    device's time for the launches back to back, without the host."""
    import torch

    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(*inputs[i % len(inputs)])
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, make_inputs, iters: int, kernel: str) -> tuple[float, int]:
    """Mean device time of one launch of the kernel whose name holds
    ``kernel``, read by ``torch.profiler`` (CUPTI) over ``iters`` calls of
    ``fn(*inputs[i % len])`` issued one by one after a warm-up, with
    ``inputs = make_inputs()`` (made here, so that nothing of it is held
    while the requests run and count to their peak memory), and the number
    of launches the profile caught.  Raises if it caught fewer than nine in
    ten, or anything else on the device (a profiler session started after
    another may miss a launch at its edge)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inputs = make_inputs()
    for args in inputs:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ours = [e for e in on_device if kernel in e.name]
    if len(ours) < 0.9 * iters or len(on_device) != len(ours):
        raise SystemExit(f"profiler: {len(ours)} launches of {kernel} and "
                         f"{len(on_device) - len(ours)} other device events for {iters} calls")
    return sum(e.time_range.elapsed_us() for e in ours) / len(ours) / 1e3, len(ours)


def fft_flops(n: int) -> float:
    """Operations of a real-input FFT of ``n`` points: half the usual
    ``5 n log2 n`` of a complex one."""
    return 2.5 * n * math.log2(n)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time in ms for ``flops`` at ``peak_flops`` and ``nbytes`` at the HBM
    rate, and which of the two sets it."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_phase(torch, rng):
    """Log-mel kernel at the serving shape [4, 68352] (bucket 128)."""
    from multimodal_av_model_tpu_torch.ops import logmel

    B, S = 4, 128 * 534
    t = np.arange(S) / 16000.0
    wave = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal((B, S)))
    x = torch.from_numpy(wave.astype(np.float32)).cuda()
    got = logmel.log_mel_spectrogram_cuda(x)
    ref = logmel.log_mel_spectrogram(x)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    ok = torch.allclose(got, ref, rtol=2e-3, atol=2e-3)
    log(f"[k1] log-mel {tuple(x.shape)} -> {tuple(got.shape)}: max|kernel-plain| = {err:.3g} "
        f"(tolerance rtol=atol=2e-3) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("K1 disagrees with its plain version")

    fb = torch.from_numpy(logmel.mel_filterbank(201, 80, 16000)).cuda()
    window = torch.hann_window(400, periodic=True, device="cuda")

    def library(sig):
        spec = torch.stft(sig, 400, 160, window=window, center=True, pad_mode="reflect",
                          return_complex=True)
        return torch.log((spec.abs() ** 2).transpose(1, 2) @ fb + 1e-6)

    lib_err = (library(x) - ref).abs().max().item()
    ms = cuda_ms(logmel.log_mel_spectrogram_cuda, [(x,)], 200, graph=True)
    eager_ms = cuda_ms(logmel.log_mel_spectrogram_cuda, [(x,)], 200)
    plain_ms = cuda_ms(logmel.log_mel_spectrogram, [(x,)], 50)
    lib_ms = cuda_ms(library, [(x,)], 50)
    T = got.shape[1]
    nnz = int(np.count_nonzero(logmel.mel_filterbank(201, 80, 16000)))
    nbytes = x.numel() * 4 + got.numel() * 4
    # The least work for the function: window, real FFT, power, the mel
    # projection over the filterbank's nonzeros and the log, in f32.
    least_flops = B * T * (400 + fft_flops(400) + 3 * 201 + 2 * nnz + 80)
    b_ms, b_by = bound(least_flops, nbytes)
    # The design bound of this kernel: the direct DFT (the algorithm of the
    # TPU kernel) and the sparse mel step, at the 3xTF32 tensor-core rate
    # that keeps f32 accuracy.
    flops = B * T * (4 * 400 * 201 + 2 * nnz)
    d_ms, d_by = bound(flops, nbytes, PEAK_3XTF32_FLOPS)
    plan = logmel.logmel_plan(B, S)
    log(f"[k1] kernel {ms:.4f} ms by graph replay, {eager_ms:.4f} ms per launch issued one by "
        f"one from Python; "
        f"plain {plain_ms:.4f} ms, torch.stft+matmul {lib_ms:.4f} ms "
        f"(max|lib-plain| {lib_err:.3g}); bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB; "
        f"{least_flops / 1e9:.4f} GFLOP of real FFT + sparse mel at 67 TFLOP/s f32), "
        f"{b_ms / ms:.3f} of it; design bound {d_ms:.4f} ms by {d_by} "
        f"({flops / 1e9:.3f} GFLOP of direct DFT + sparse mel at the 3xTF32 tensor-core rate, "
        f"165 TFLOP/s), {d_ms / ms:.3f} of it; achieved {flops / ms / 1e6:.1f} GFLOP/s of "
        f"direct DFT; launch {plan['ctas']} CTAs in clusters of {logmel.CLUSTER} x "
        f"{plan['threads']} threads, {plan['smem_bytes']} B shared memory")
    return {"name": "logmel", "route": "cuda",
            "source": "multimodal_av_model_tpu_torch/csrc/logmel.cu",
            "replaces": "multimodal_av_model_tpu/ops/pallas/logmel_kernel.py:110",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}, \
        (logmel.log_mel_spectrogram_cuda, lambda: [(x,)], 200, "logmel_kernel")


def k2_phase(torch, rng):
    """Lip kernel at the serving shape: 512 = 4 x 128 uint8 crops of 128x128x3."""
    import torch.nn.functional as F

    from multimodal_av_model_tpu_torch.ops import resize

    N, H, W, C, O = 512, 128, 128, 3, 96
    # Four distinct batches (100 MB) so timed launches do not find their
    # input in the 50 MB L2, as the serving path does not.
    inputs = [torch.from_numpy(rng.integers(0, 256, size=(N, H, W, C), dtype=np.uint8)).cuda()
              for _ in range(4)]
    x = inputs[0]
    got = resize.lip_preprocess_cuda(x, O)
    ref = resize.lip_frames_preprocess(x, O)
    got_f32 = resize.lip_preprocess_cuda(x.float(), O)
    torch.cuda.synchronize()
    err = max((got - ref).abs().max().item(), (got_f32 - ref).abs().max().item())
    ok = (torch.allclose(got, ref, rtol=1e-4, atol=1e-3)
          and torch.allclose(got_f32, ref, rtol=1e-4, atol=1e-3))
    log(f"[k2] lip {tuple(x.shape)} uint8 and f32 -> {tuple(got.shape)}: max|kernel-plain| = "
        f"{err:.3g} (tolerance rtol=1e-4, atol=1e-3) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("K2 disagrees with its plain version")

    def library(frames):
        gray = frames.float().mean(dim=-1)[:, None]
        return F.interpolate(gray, size=(O, O), mode="bilinear", align_corners=False) / 255.0

    lib_err = (library(x) - ref).abs().max().item()
    args = [(f, O) for f in inputs]
    ms = cuda_ms(resize.lip_preprocess_cuda, args, 100, graph=True)
    eager_ms = cuda_ms(resize.lip_preprocess_cuda, args, 100)
    plain_ms = cuda_ms(resize.lip_frames_preprocess, args, 20)
    lib_ms = cuda_ms(library, [(f,) for f in inputs], 20)
    nbytes = x.numel() + got.numel() * 4
    flops = N * O * O * (4 * C + 10)
    b_ms, b_by = bound(flops, nbytes)
    plan = resize.lip_band_plan(H, W, C, O, O, 1)
    log(f"[k2] kernel {ms:.4f} ms by graph replay, {eager_ms:.4f} ms per launch issued one by "
        f"one from Python; "
        f"plain {plain_ms:.4f} ms, mean+F.interpolate {lib_ms:.4f} ms "
        f"(max|lib-plain| {lib_err:.3g}); bound {b_ms:.4f} ms by {b_by} "
        f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); achieved "
        f"{nbytes / ms / 1e6:.1f} GB/s, {b_ms / ms:.3f} of the bound; launch "
        f"{plan['n_bands'] * N} CTAs ({plan['n_bands']} bands of {plan['rows_per_band']} "
        f"output rows x {N} frames) x 256 threads, {plan['smem_bytes']} B shared memory")

    def fresh_inputs():                         # four batches again, as above
        return [(torch.randint(0, 256, (N, H, W, C), dtype=torch.uint8, device="cuda"), O)
                for _ in range(4)]
    return {"name": "lip_preprocess", "route": "cuda",
            "source": "multimodal_av_model_tpu_torch/csrc/lip_preprocess.cu",
            "replaces": "multimodal_av_model_tpu/ops/pallas/lip_kernel.py:48",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}, \
        (resize.lip_preprocess_cuda, fresh_inputs, 100, "lip_kernel")


def k3_phase(torch, rng):
    """Prefix-beam kernel at the serving shape: the [2B] = 8 rows of a
    bucket-128 request, f32 log-probs [8, 128, 800], lengths U[64, 128], beam
    5, top-k 8."""
    from multimodal_av_model_tpu_torch.ops import prefix_beam_search as pbs

    B, T, V, W, K = 8, 128, 800, 5, 8
    logits = 3.0 * rng.standard_normal((B, T, V))
    lp_np = logits - logits.max(-1, keepdims=True)
    lp_np -= np.log(np.exp(lp_np).sum(-1, keepdims=True))
    lp = torch.from_numpy(lp_np.astype(np.float32)).cuda()
    lens = torch.from_numpy(rng.integers(64, T + 1, B)).cuda()
    args = (lp, lens, None, None, None, None, None, W, K, 3, -1, 0.0, 0.0)
    got = pbs.prefix_beam_op(*args)
    want = pbs._prefix_beam_plain(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(g, w) for i, (g, w) in enumerate(zip(got, want)) if i not in (2, 3, 6))
    err = max((g - w).abs().max().item() for i, (g, w) in enumerate(zip(got, want))
              if i in (2, 3, 6) and g.numel())
    ok = same and err <= 1e-5 * max(1.0, want[6].abs().max().item())
    log(f"[k3] prefix beam {tuple(lp.shape)} f32, lengths {lens.tolist()}: ids, lengths and "
        f"prefixes {'equal to' if same else 'DIFFER from'} the plain loop's, max|score, pb, "
        f"pnb - plain| = {err:.3g} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("K3 disagrees with its plain version")

    def kernel(*a):
        return pbs.prefix_beam_op(*a)

    ms = cuda_ms(kernel, [args], 20, graph=True)
    eager_ms = cuda_ms(kernel, [args], 20)
    plain_ms = cuda_ms(pbs._prefix_beam_plain, [args], 3)
    nbytes = lp.numel() * lp.element_size() + lens.numel() * 8 + B * (T * 4 + 8)
    b_ms, b_by = bound(0.0, nbytes)
    plan = pbs.prefix_beam_plan(T, W, K, T)
    log(f"[k3] kernel {ms:.4f} ms by graph replay, {eager_ms:.4f} ms per launch called one by "
        f"one from Python; plain loop {plain_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} "
        f"({nbytes / 1e6:.2f} MB read once), {b_ms / ms:.4f} of it: a serial chain of "
        f"{int(lens.max())} frames, {ms / int(lens.max()) * 1e3:.2f} us a frame; launch {B} CTAs "
        f"x 256 threads, {plan['smem_bytes']} B shared memory (prefix rows there: "
        f"{plan['rows_in_smem']}), top-K staged {plan['tile']} frames at a time")
    return {"name": "prefix_beam", "route": "cuda",
            "source": "multimodal_av_model_tpu_torch/csrc/prefix_beam.cu",
            "replaces": "none (the JAX decode is lax.scan code)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def k4_phase(torch, rng):
    """LSTM recurrence kernel at the cells' shapes: ``[128, 2, R, 2048]`` bf16
    gates for R = 8 (a request's rows) and 16 (a ``train_b8`` step's), H 512,
    lengths U[64, 128]: the forward's output and the backward's gate
    gradient against the f64 plain loop beside the bf16 plain loop's errors,
    then each timed by graph replay beside the plain loop (forward, and
    forward with autograd's backward) and beside the library's LSTM layer
    (``nn.LSTM``, bf16 and f16) at equal lengths, input projection included,
    against the same projection and K4."""
    import torch.nn.functional as F

    from multimodal_av_model_tpu_torch.ops import lstm_scan as ls

    T, H = 128, 512
    rows = []
    for R in (8, 16):
        g = torch.Generator().manual_seed(R)
        z = torch.randn(R, T, 2, 4 * H, generator=g).cuda().bfloat16()
        w = ((torch.rand(2, 4 * H, H, generator=g) * 2 - 1) / H ** 0.5).cuda().bfloat16()
        b = (0.1 * torch.randn(2, 4 * H, generator=g)).cuda().bfloat16()
        dy = torch.randn(R, T, 2, H, generator=g).cuda().bfloat16()
        lens = torch.from_numpy(rng.integers(64, T + 1, R)).cuda()

        def plain(dtype, zz):
            return ls._forward_plain(zz, lens, w.to(dtype), b.to(dtype), False)[0]

        y, saved = ls.lstm_scan_op(z, lens, w, b, True)
        dz = ls.lstm_scan_backward_op(dy, lens, w, saved)
        errs = {}
        for dtype in (torch.float64, torch.bfloat16):
            zz = z.to(dtype).requires_grad_()
            yy = plain(dtype, zz)
            (gz,) = torch.autograd.grad(yy, zz, dy.to(dtype))
            errs[dtype] = (yy.detach().double(), gz.double())
        (y64, dz64), (yp, dzp) = errs[torch.float64], errs[torch.bfloat16]
        e_y, e_dz = (y.double() - y64).abs().max().item(), (dz.double() - dz64).abs().max().item()
        p_y, p_dz = (yp - y64).abs().max().item(), (dzp - dz64).abs().max().item()
        ok = e_y <= 1.1 * p_y and e_dz <= 1.1 * p_dz
        log(f"[k4] [{T}, 2, {R}, {4 * H}] bf16, lengths {lens.tolist()}: max|y - f64| kernel "
            f"{e_y:.3g}, bf16 plain {p_y:.3g}; max|dz - f64| kernel {e_dz:.3g}, bf16 plain "
            f"{p_dz:.3g} {'ok' if ok else 'FAILED'}")
        if not ok:
            raise SystemExit("K4 is further from the f64 loop than the bf16 plain loop")

        def fwd():
            return ls.lstm_scan_op(z, lens, w, b, False)

        def fwd_save():
            return ls.lstm_scan_op(z, lens, w, b, True)

        def bwd():
            return ls.lstm_scan_backward_op(dy, lens, w, saved)

        def plain_fb():
            zz = z.detach().requires_grad_()
            return torch.autograd.grad(plain(torch.bfloat16, zz), zz, dy)

        ms = {"forward": cuda_ms(fwd, [()], 20, graph=True),
              "forward_save": cuda_ms(fwd_save, [()], 20, graph=True),
              "backward": cuda_ms(bwd, [()], 20, graph=True),
              "forward_eager": cuda_ms(fwd, [()], 20),
              "plain_forward": cuda_ms(lambda: plain(torch.bfloat16, z), [()], 3),
              "plain_forward_backward": cuda_ms(plain_fb, [()], 3)}
        # The library's bidirectional LSTM layer on the same rows, all T
        # frames valid, its input projection inside; beside it the layer's
        # own projection and K4 on the same work.
        x = torch.randn(R, T, H, generator=g).cuda()
        w_ih = (torch.randn(2 * 4 * H, H, generator=g) / H ** 0.5).cuda().bfloat16()
        full = torch.full((R,), T, dtype=torch.int64, device="cuda")

        def k4_layer(xb=x.bfloat16()):
            return ls.lstm_scan_op(F.linear(xb, w_ih).view(R, T, 2, 4 * H), full, w, b, False)

        ms["k4_layer_equal_lengths"] = cuda_ms(k4_layer, [()], 20, graph=True)
        lib_route = {}
        for tag, dtype in (("bf16", torch.bfloat16), ("f16", torch.float16)):
            lstm = torch.nn.LSTM(H, H, bidirectional=True, batch_first=True).cuda().to(dtype)
            lstm.flatten_parameters()
            xd = x.to(dtype)
            with torch.no_grad():
                ms[f"library_{tag}"] = cuda_ms(lambda: lstm(xd), [()], 20, graph=True)
            takes = "takes" if torch.backends.cudnn.is_acceptable(xd) else "does not take"
            lib_route[tag] = f"cuDNN {takes} {dtype}"
            del lstm
        # Least time a frame: a CTA reads its W_hh slice (4U x H bf16, 128 KiB)
        # from shared memory at 128 B a clock at 1.98 GHz, or computes its
        # 2 R 4U H operations at a 132nd of 989 TFLOP/s; the frames are a
        # serial chain.
        plan = ls.lstm_scan_plan("forward", R, H, 2)
        U, steps = plan["U"], int(lens.max())
        frame_us = max(4 * U * H * 2 / (128 * 1.98e9),
                       2 * R * 4 * U * H / (PEAK_BF16_FLOPS / 132)) * 1e6
        bound_ms = steps * frame_us / 1e3
        log(f"[k4] R = {R}: forward {ms['forward']:.4f} ms ({ms['forward'] / steps * 1e3:.2f} us a "
            f"frame), saving {ms['forward_save']:.4f}, backward {ms['backward']:.4f} ms by graph "
            f"replay; forward called from Python {ms['forward_eager']:.4f} ms; plain loop "
            f"forward {ms['plain_forward']:.4f} ms, forward and backward "
            f"{ms['plain_forward_backward']:.4f} ms; bound {bound_ms:.4f} ms ({steps} frames x "
            f"{frame_us:.3f} us); clusters of {plan['cs']} CTAs x 256 threads, {plan['rows']} "
            f"rows, {plan['smem_bytes']} B shared memory forward, "
            f"{ls.lstm_scan_plan('backward', R, H, 2)['smem_bytes']} B backward")
        log(f"[k4] R = {R}, all {T} frames valid, input projection included: nn.LSTM({H}, {H}, "
            f"bidirectional) bf16 {ms['library_bf16']:.4f} ms ({lib_route['bf16']}), f16 "
            f"{ms['library_f16']:.4f} ms ({lib_route['f16']}); the layer's projection and K4 "
            f"{ms['k4_layer_equal_lengths']:.4f} ms; all by graph replay")
        rows.append({"R": R, "err_y": e_y, "err_dz": e_dz, "plain_err_y": p_y,
                     "plain_err_dz": p_dz, "bound_ms": bound_ms, **ms})
    return {"name": "lstm_scan", "route": "cuda",
            "source": "multimodal_av_model_tpu_torch/csrc/bilstm.cu",
            "replaces": "none (the JAX BiLSTM is lax.scan code)", "shapes": rows,
            "ms": rows[0]["forward"], "plain_ms": rows[0]["plain_forward"],
            "bound_ms": rows[0]["bound_ms"], "bound_by": "serial chain",
            "library_ms": rows[0]["library_bf16"]}


@contextlib.contextmanager
def k4_recording():
    """The inputs ``(z, lengths, w_hh, bias)`` of each ``mmav::lstm_scan``
    call made inside the block (each BiLSTM layer's own), in order."""
    from multimodal_av_model_tpu_torch.ops import lstm_scan as ls

    calls, real = [], ls.lstm_scan_op

    def recording(z, lengths, w_hh, bias, save):
        calls.append((z, lengths, w_hh, bias))
        return real(z, lengths, w_hh, bias, save)

    ls.lstm_scan_op = recording
    try:
        yield calls
    finally:
        ls.lstm_scan_op = real


def k4_agrees(torch, call, tag: str) -> None:
    """K4 against the plain loop on one call of a main path
    (``k4_recording``): its output no further from the loop in f64 than the
    loop in the call's dtype is, with 10 % slack (the ``gpu`` tests' rule)."""
    from multimodal_av_model_tpu_torch.ops import lstm_scan as ls

    z, lengths, w, b = call
    with torch.no_grad():
        got = ls.lstm_scan_op(z, lengths, w, b, False)[0].double()
        want = ls._forward_plain(z.double(), lengths, w.double(), b.double(), False)[0]
        plain = ls._forward_plain(z, lengths, w, b, False)[0].double()
    err, p_err = (got - want).abs().max().item(), (plain - want).abs().max().item()
    ok = err <= 1.1 * p_err
    log(f"[{tag}] K4 on a BiLSTM layer's own gates {tuple(z.shape)} {z.dtype}, lengths "
        f"{lengths.tolist()}: max|y - f64 loop| kernel {err:.3g}, plain loop in {z.dtype} "
        f"{p_err:.3g} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{tag}: K4 is further from the f64 loop than the plain loop")


def k3_agrees(got, want) -> tuple[bool, float]:
    """K3's outputs against the plain loop's, as the ``gpu`` tests hold them:
    the integer ones (prefixes, lengths, ids) equal, the float ones (pb, pnb,
    score) within 1e-5, relative above magnitude 1.  Returns whether they
    agree and the largest |difference| of the floats."""
    ok, err = True, 0.0
    for g, w in zip(got, want):
        if not g.dtype.is_floating_point:
            ok = ok and g.dtype == w.dtype and bool((g == w).all()) and g.shape == w.shape
        elif g.numel():
            d = (g - w).abs()
            err = max(err, d.max().item())
            ok = ok and bool((d <= 1e-5 * w.abs().clamp(min=1.0)).all())
    return ok, err


def make_request(rng, B: int, spec, crop: int = 128):
    """B raw two-speaker samples at ``spec``'s bucket, made with numpy, then
    collated on the host (uint8 crops, per-speaker waveforms, lengths)."""
    from multimodal_av_model_tpu_torch.data.collate import collate_pairs_raw

    samples = []
    for _ in range(B):
        s = {}
        for k in ("1", "2"):
            T = int(rng.integers(spec.video_frames // 2, spec.video_frames + 1))
            n = min(T * 534, spec.audio_samples)
            tt = np.arange(n) / 16000.0
            f0 = rng.uniform(100, 300)
            s["lip" + k + "_raw"] = rng.integers(0, 256, size=(T, crop, crop, 3), dtype=np.uint8)
            s["audio" + k] = (0.3 * np.sin(2 * np.pi * f0 * tt)
                              + 0.05 * rng.standard_normal(n)).astype(np.float32)
            s["label" + k] = rng.integers(4, 800, size=int(rng.integers(5, 30)))
        samples.append(s)
    return collate_pairs_raw(samples, spec)


def _flagship_batch(torch, raw):
    from multimodal_av_model_tpu_torch.data.device_pipeline import preprocess_batch_device

    batch = preprocess_batch_device(raw["lip1_raw"], raw["lip2_raw"], raw["audio1"],
                                    raw["audio2"], raw["audio1_len"], raw["audio2_len"],
                                    device="cuda")
    batch["lip1_lengths"], batch["lip2_lengths"] = raw["lip1_lengths"], raw["lip2_lengths"]
    return batch


def tiny_model_config():
    from multimodal_av_model_tpu_torch.config import Config

    cfg = Config()
    a, v, f = cfg.model.audio, cfg.model.visual, cfg.model.fusion
    a.d_model, a.num_layers, a.num_heads, a.ffn_dim = 32, 3, 2, 64
    a.conv_kernel_size, a.middle_layers, a.output_dim = 7, (1, 2), 48
    v.frontend_channels, v.resnet_layers = 8, (1, 1, 1, 1)
    v.resnet_channels, v.output_dim, v.norm = (8, 12, 16, 24), 24, "batch"
    f.fused_dim, f.num_heads = 16, 2
    cfg.model.decoder.vocab_size = 40
    cfg.model.contrastive.projection_dim = 8
    cfg.model.dtype = "float32"
    return cfg


def reference_phase(torch, rng, temporal_model: str = "bilstm", tag: str = "reference"):
    """The whole path at a small width in f32: card (kernels) vs CPU (plain)."""
    from multimodal_av_model_tpu_torch.data.collate import make_bucket_specs
    from multimodal_av_model_tpu_torch.data.device_pipeline import preprocess_batch_device
    from multimodal_av_model_tpu_torch.infer import decode_ids
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel, init_weights

    cfg = tiny_model_config()
    cfg.model.fusion.temporal_model = temporal_model
    spec = make_bucket_specs((16,), 534, 8)[0]
    raw = make_request(rng, 2, spec, crop=48)
    model = init_weights(MultiSpeakerAVModel(cfg.model), torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    for name, buf in model.named_buffers():        # non-trivial BatchNorm statistics
        buf.copy_(torch.rand(buf.shape, generator=g) + (0.5 if "var" in name else -0.5))
    keys = ("lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")
    outs = {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev).eval()
        batch = preprocess_batch_device(raw["lip1_raw"], raw["lip2_raw"], raw["audio1"],
                                        raw["audio2"], raw["audio1_len"], raw["audio2_len"],
                                        out_size=24, device=dev)
        batch["lip1_lengths"] = torch.from_numpy(raw["lip1_lengths"]).to(dev)
        batch["lip2_lengths"] = torch.from_numpy(raw["lip2_lengths"]).to(dev)
        with torch.no_grad():
            outs[dev] = (batch, m(*[batch[k] for k in keys]))
    (b_cpu, o_cpu), (b_gpu, o_gpu) = outs["cpu"], outs["cuda"]
    lip_err = max((b_gpu[k].cpu() - b_cpu[k]).abs().max().item() for k in ("lip1", "lip2"))
    lp_err = 0.0
    for s in ("1", "2"):
        if not torch.equal(o_gpu["input_lengths" + s].cpu(), o_cpu["input_lengths" + s]):
            raise SystemExit(f"{tag}: input_lengths differ between card and CPU")
        for b, n in enumerate(o_cpu["input_lengths" + s].tolist()):
            d = (o_gpu["log_probs" + s][b, :n].cpu() - o_cpu["log_probs" + s][b, :n]).abs()
            lp_err = max(lp_err, d.max().item() if n else 0.0)
    lp = torch.cat([o_cpu["log_probs1"], o_cpu["log_probs2"]])
    lens = torch.cat([o_cpu["input_lengths1"], o_cpu["input_lengths2"]])
    ids_cpu, n_cpu = decode_ids(cfg, lp, lens)
    ids_gpu, n_gpu = decode_ids(cfg, lp.cuda(), lens.cuda())
    same_ids = torch.equal(ids_cpu, ids_gpu.cpu()) and torch.equal(n_cpu, n_gpu.cpu())
    ok = lip_err <= 1e-3 and lp_err <= 1e-3 and same_ids
    log(f"[{tag}] small f32 model ({temporal_model} temporal model), card vs CPU: max|lips| "
        f"{lip_err:.3g} (<= 1e-3), max|log_probs| on valid frames {lp_err:.3g} (<= 1e-3), "
        f"prefix-beam ids {'equal' if same_ids else 'DIFFER'} {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{tag} phase failed")


def serving_phase(torch, rng, tok):
    from multimodal_av_model_tpu_torch.config import Config, torch_dtype
    from multimodal_av_model_tpu_torch.data.collate import make_bucket_specs
    from multimodal_av_model_tpu_torch.infer import Transcriber
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel, init_weights
    from multimodal_av_model_tpu_torch.ops import launch_counts

    cfg = Config()                                  # the shipped flagship defaults
    dtype = torch_dtype(cfg.model.dtype)
    t0 = time.perf_counter()
    model = init_weights(MultiSpeakerAVModel(cfg.model, dtype), torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    transcriber = Transcriber(cfg, tok, model, device="cuda")
    log(f"[serving] flagship {n_params / 1e6:.1f}M params ({cfg.model.dtype} compute, f32 "
        f"params), seeded init + to(cuda) {time.perf_counter() - t0:.1f} s")
    specs = {s.video_frames: s for s in make_bucket_specs(cfg.data.video_buckets,
                                                          cfg.data.audio_samples_per_video_frame,
                                                          cfg.data.max_label_len)}
    plan = [128, 128, 128, 64]
    requests = [make_request(rng, 4, specs[T]) for T in plan]
    captured = []
    model.register_forward_hook(lambda mod, args, out: captured.append(out))

    def serve(raw):
        return transcriber.transcribe(_flagship_batch(torch, raw))

    for T in sorted(set(plan)):                     # warm-up, one per bucket shape
        serve(requests[plan.index(T)])
    torch.cuda.synchronize()
    captured.clear()

    torch.cuda.reset_peak_memory_stats()
    since = launch_counts()
    lat, all_texts, per_request = [], [], []
    with k4_recording() as k4_calls:
        for raw in requests:                        # the main path
            before = launch_counts()
            t0 = time.perf_counter()
            texts = serve(raw)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            all_texts.append(texts)
            per_request.append(tuple(launch_counts(before).values()))
    launches = launch_counts(since)
    peak = torch.cuda.max_memory_allocated()

    n_req = len(requests)
    if any(k1 < 1 or k2 < 2 or k3 != 1 or k4 != 2 for k1, k2, k3, k4 in per_request):
        raise SystemExit(f"serving: kernels not on the main path, launches {per_request} "
                         f"(expected K3 1 and K4 2 a request)")
    k4_agrees(torch, k4_calls[0], "serving")
    if len(captured) != n_req:
        raise SystemExit(f"serving: {len(captured)} forwards for {n_req} requests")
    for raw, texts, out in zip(requests, all_texts, captured):
        T_v = raw["lip1_raw"].shape[1]
        for s in ("1", "2"):
            lp = out["log_probs" + s].float()
            if lp.shape[:2] != (4, T_v) or lp.shape[2] != cfg.model.decoder.vocab_size:
                raise SystemExit(f"serving: log_probs shape {tuple(lp.shape)}")
            if not torch.isfinite(lp).all():
                raise SystemExit("serving: non-finite log-probs")
            if (lp.logsumexp(-1).abs() > 1e-3).any():
                raise SystemExit("serving: log-prob rows do not normalise")
            if (out["input_lengths" + s] > T_v).any():
                raise SystemExit("serving: input_lengths exceed T_v")
        if len(texts) != 4 or any(len(p) != 2 or not all(isinstance(x, str) for x in p)
                                  for p in texts):
            raise SystemExit("serving: expected one text per speaker")
    for T, dt in zip(plan, lat):
        log(f"[serving] request B=4 bucket {T}: {dt * 1e3:.1f} ms, {4 / dt:.2f} utt/s "
            f"(utt = one two-speaker mixture)")
    log(f"[serving] {n_req} requests, {4 * n_req} mixtures in {sum(lat):.3f} s: "
        f"{4 * n_req / sum(lat):.2f} utt/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}; first texts "
        f"{json.dumps(all_texts[0][0])[:120]}")

    def profile_request():
        traced(torch, "layers", "one bucket-128 request", lambda: serve(requests[0]))
    return launches, profile_request, (transcriber, requests, plan, lat)


def traced(torch, tag: str, what: str, run) -> None:
    """``run()`` once with the port's recorder on (``tracing``): its spans by
    name with their host and device ms and host syncs."""
    from multimodal_av_model_tpu_torch import tracing

    torch.cuda.synchronize()
    tracing.enable("cuda")
    try:
        t0 = time.perf_counter()
        with tracing.unit(0):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        tracing.disable()
    rows = tracing.summary(tracing.collect())
    log(f"[{tag}] {what}, {wall:.1f} ms wall with the recorder on; spans (n, host ms, device "
        "ms, host syncs): " + "; ".join(
            f"{k} {r['n']:g} {r['host_ms']:.2f} {r['device_ms']:.2f} {r.get('host_syncs', 0):g}"
            for k, r in rows.items()))


def make_train_batch(rng, B: int, spec, crop: int = 128, frames: int = 120,
                     label_len: int = 20, vocab: int = 800):
    """B raw two-speaker samples with ``bench.py``'s shapes (``bench.py:24-36``):
    clips of ``frames`` frames, ``frames * 534`` samples of speaker 1 and
    60-100 % of that of speaker 2 (so both speakers have solo frames for the
    contrastive loss), labels of ``label_len`` tokens below ``vocab``, uint8
    crops; collated to ``spec``'s bucket on the host."""
    from multimodal_av_model_tpu_torch.data.collate import collate_pairs_raw

    samples = []
    for _ in range(B):
        s = {}
        for k, frac in (("1", 1.0), ("2", rng.uniform(0.6, 1.0))):
            n = int(frames * 534 * frac)
            tt = np.arange(n) / 16000.0
            s["lip" + k + "_raw"] = rng.integers(0, 256, size=(frames, crop, crop, 3),
                                                 dtype=np.uint8)
            s["audio" + k] = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * tt)
                              + 0.05 * rng.standard_normal(n)).astype(np.float32)
            s["label" + k] = rng.integers(4, vocab, size=label_len)
        samples.append(s)
    return collate_pairs_raw(samples, spec)


def train_ref_phase(torch, rng, tok):
    """One training step of a small f32 model from one seeded state: card
    (K1, K2) vs CPU (plain versions), on the same raw batch."""
    from multimodal_av_model_tpu_torch.data.collate import make_bucket_specs
    from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer

    cfg = tiny_model_config()
    cfg.model.audio.dropout = 0.0
    raw = make_train_batch(rng, 2, make_bucket_specs((64,), 534, 16)[0], crop=48,
                           frames=56, label_len=10, vocab=cfg.model.decoder.vocab_size)
    runs = {}
    for dev in ("cpu", "cuda"):
        trainer = MultiSpeakerTrainer(cfg, MultiSpeakerAVModel(cfg.model), tok, device=dev)
        state = trainer.init_state(1)
        (batch,) = device_preprocessed_batches([raw], out_size=24, device=dev)
        state, m = trainer.train_step(state, batch)
        model = state.model
        runs[dev] = ({k: v.item() for k, v in m.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()},
                     {n: b.cpu() for n, b in model.named_buffers()})
    (m_cpu, g_cpu, s_cpu), (m_gpu, g_gpu, s_gpu) = runs["cpu"], runs["cuda"]
    loss_rel = abs(m_gpu["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    gn_rel = abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) / m_cpu["grad_norm"]
    # Per tensor, relative to its own norm plus 1e-3 of the global norm (a
    # gradient that is zero in exact arithmetic, as a key bias's, is noise).
    floor = 1e-3 * m_cpu["grad_norm"]
    g_rel, g_name = max((float((g_gpu[n] - g).norm() / (g.norm() + floor)), n)
                        for n, g in g_cpu.items())
    s_rel, s_name = max((float(((s_gpu[n] - b).abs() / (b.abs() + 1e-3)).max()), n)
                        for n, b in s_cpu.items())
    ok = loss_rel <= 1e-3 and gn_rel <= 1e-2 and g_rel <= 1e-2 and s_rel <= 1e-3
    log(f"[train-ref] small f32 model, one step, card vs CPU: loss {m_gpu['loss']:.6f} vs "
        f"{m_cpu['loss']:.6f} (rel {loss_rel:.3g}, <= 1e-3), grad_norm rel {gn_rel:.3g} "
        f"(<= 1e-2), max per-tensor gradient rel {g_rel:.3g} at {g_name} (<= 1e-2, "
        f"|dg| / (|g| + 1e-3 grad_norm)), BatchNorm statistics max rel {s_rel:.3g} at "
        f"{s_name} (<= 1e-3) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("train-ref phase failed")


def train_kernel_check(torch, B: int, raw, tag: str = "train") -> None:
    """K1 and K2 on the card at the shapes a B-pair training step gives them
    (K1 the mixture ``[B, 68352]``, K2 each speaker's ``B * 128`` crops),
    each against its plain version with the bars of phase 3, then timed by
    graph replay.  Called before the counted steps."""
    from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches
    from multimodal_av_model_tpu_torch.ops import logmel, resize

    (batch,) = device_preprocessed_batches([raw])
    audio = batch["audio"].float().contiguous()     # what the audio encoder gives K1
    got, ref = logmel.log_mel_spectrogram_cuda(audio), logmel.log_mel_spectrogram(audio)
    k1_err = (got - ref).abs().max().item()
    k1_ok = torch.allclose(got, ref, rtol=2e-3, atol=2e-3)
    crops, k2_err, k2_ok = [], 0.0, True
    for k in ("1", "2"):                            # as preprocess_batch_device reshapes them
        c = torch.from_numpy(raw["lip" + k + "_raw"]).cuda()
        c = c.reshape(-1, *c.shape[2:])
        got, ref = resize.lip_preprocess_cuda(c, 96), resize.lip_frames_preprocess(c, 96)
        k2_err = max(k2_err, (got - ref).abs().max().item())
        k2_ok = k2_ok and torch.allclose(got, ref, rtol=1e-4, atol=1e-3)
        crops.append(c)
    del got, ref
    k1_ms = cuda_ms(logmel.log_mel_spectrogram_cuda, [(audio,)], 100, graph=True)
    k2_ms = cuda_ms(resize.lip_preprocess_cuda, [(c, 96) for c in crops], 50, graph=True)
    ok = k1_ok and k2_ok
    log(f"[{tag}] B={B} kernels at the step's shapes: K1 {tuple(audio.shape)}: "
        f"max|kernel-plain| {k1_err:.3g} (rtol=atol=2e-3), {k1_ms:.4f} ms by graph replay; "
        f"K2 {tuple(crops[0].shape)} uint8 x 2: max|kernel-plain| {k2_err:.3g} (rtol 1e-4, "
        f"atol 1e-3), {k2_ms:.4f} ms per launch by graph replay {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{tag}: a kernel disagrees with its plain version at B={B}")


def train_phase(torch, rng, tok, runs=((8, "none", 10), (32, "frontend", 5)),
                temporal_model: str = "bilstm", tag: str = "train"):
    """The flagship training step at the shipped defaults, B = 8 and 32 (or
    the ``(B, remat, steps)`` of ``runs``), with ``temporal_model``."""
    from torch.utils.flop_counter import FlopCounterMode

    from multimodal_av_model_tpu_torch.config import Config, torch_dtype
    from multimodal_av_model_tpu_torch.data.collate import make_bucket_specs
    from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
    from multimodal_av_model_tpu_torch.ops import launch_counts
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer

    launches = {"logmel": 0, "lip_preprocess": 0, "prefix_beam": 0, "lstm_scan": 0}
    profile_step = None
    for B, remat, n_steps in runs:
        cfg = Config()                              # the shipped flagship defaults
        cfg.model.visual.remat = remat
        cfg.model.fusion.temporal_model = temporal_model
        spec = make_bucket_specs((128,), cfg.data.audio_samples_per_video_frame,
                                 cfg.data.max_label_len)[0]
        raw = make_train_batch(rng, B, spec)
        train_kernel_check(torch, B, raw, tag)
        t0 = time.perf_counter()
        trainer = MultiSpeakerTrainer(
            cfg, MultiSpeakerAVModel(cfg.model, torch_dtype(cfg.model.dtype)), tok)
        state = trainer.init_state(cfg.data.seed)
        n_params = sum(p.numel() for p in state.model.parameters())
        init_s = time.perf_counter() - t0

        def step(trainer=trainer, state=state, raw=raw):
            (batch,) = device_preprocessed_batches([raw])
            return trainer.train_step(state, batch)[1]

        for _ in range(2):                          # warm-up
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        since = launch_counts()
        times, metrics = [], []
        for _ in range(n_steps):                    # the main path
            t0 = time.perf_counter()
            metrics.append(step())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        k1, k2, k3, k4 = launch_counts(since).values()
        peak = torch.cuda.max_memory_allocated()
        launches = add_launches(launches, (k1, k2, k3, k4))
        losses = [m["loss"].item() for m in metrics]
        gnorms = [m["grad_norm"].item() for m in metrics]
        with FlopCounterMode(display=False) as counter:
            step()
            torch.cuda.synchronize()
        flops = counter.get_total_flops()
        # Rates take all the work over all the time, as [serving] does: a
        # stall in the window counts.
        mean, med = sum(times) / n_steps, float(np.median(times))
        log(f"[{tag}] B={B} remat={remat}: {n_params / 1e6:.1f}M params ({cfg.model.dtype} "
            f"compute, f32 params), init {init_s:.1f} s; {n_steps} steps in {sum(times):.3f} s: "
            f"{B * n_steps / sum(times):.2f} utt/s (utt = one two-speaker mixture), "
            f"{mean * 1e3:.1f} ms per step mean, {med * 1e3:.1f} median "
            f"({min(times) * 1e3:.1f}-{max(times) * 1e3:.1f}); peak device memory "
            f"{peak / 2**30:.2f} GiB; launches per step K1 {k1 / n_steps:g}, K2 "
            f"{k2 / n_steps:g}, K4 {k4 / n_steps:g}; loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"grad_norm "
            f"{gnorms[0]:.3f} -> {gnorms[-1]:.3f}; {flops / 1e12:.3f} TFLOP per step "
            f"(FlopCounterMode), mfu {flops / mean / PEAK_BF16_FLOPS:.4f} of 989 TFLOP/s "
            f"dense bf16 at the mean step")
        k4_step = 4 if temporal_model == "bilstm" else 0
        if k1 != n_steps or k2 != 2 * n_steps or k3 != 0 or k4 != k4_step * n_steps:
            raise SystemExit(f"{tag}: launches K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4} over "
                             f"{n_steps} steps (expected 1, 2, 0 and {k4_step} per step)")
        if not all(math.isfinite(x) for x in losses + gnorms):
            raise SystemExit(f"{tag}: non-finite losses {losses} or grad norms {gnorms}")
        if B == 8 and not losses[-1] < losses[0]:
            raise SystemExit(f"{tag}: the loss did not fall over the B=8 steps: {losses}")
        if profile_step is None:
            profile_step = step
        state.model.zero_grad(set_to_none=True)     # free the gradients till then
    return launches, profile_step


class _Tee:
    """Writes to the real stdout and keeps a copy of the text."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, text):
        self.text.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def fit_phase(torch, tok, smi: str):
    """[fit]: the training run at full width through the port's CLI on a
    corpus written in the AI-Hub layout, then a resume, --eval, --infer and
    a --synthetic epoch and one longer epoch from disk.  Returns the
    kernels' launches over these calls."""
    import contextlib
    import shutil
    import tempfile

    from multimodal_av_model_tpu_torch import main as cli
    from multimodal_av_model_tpu_torch.config import Config
    from multimodal_av_model_tpu_torch.data.manifest import (
        build_data_list,
        speaker_id_of,
        train_val_test_split,
    )
    from multimodal_av_model_tpu_torch.data.synth_corpus import write_synthetic_corpus
    from multimodal_av_model_tpu_torch.infer import Transcriber
    from multimodal_av_model_tpu_torch.ops import launch_counts, logmel
    from multimodal_av_model_tpu_torch.ops.logmel import log_mel_spectrogram_cuda
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer

    # K1 at the one shape of this phase no other phase holds: a --synthetic
    # step's [8, 64 * 534] mixture (bucket 64).  Not counted.
    x = torch.randn(8, 64 * 534, generator=torch.Generator().manual_seed(5)).cuda() * 0.3
    got, ref = log_mel_spectrogram_cuda(x), logmel.log_mel_spectrogram(x)
    err = (got - ref).abs().max().item()
    if not torch.allclose(got, ref, rtol=2e-3, atol=2e-3):
        raise SystemExit(f"fit: K1 disagrees with its plain version at {tuple(x.shape)}: {err}")
    log(f"[fit] K1 {tuple(x.shape)} (a --synthetic step): max|kernel-plain| {err:.3g} "
        f"(rtol=atol=2e-3) ok")
    del x, got, ref

    # Launches per call of each entry that runs a kernel.
    calls = {"train_step": 0, "eval_step": 0, "transcribe": 0}
    wrapped = [(MultiSpeakerTrainer, "train_step"), (MultiSpeakerTrainer, "eval_step"),
               (Transcriber, "transcribe")]
    originals = {name: getattr(cls, name) for cls, name in wrapped}

    def counting(name):
        def call(*args, **kwargs):
            before = launch_counts()
            out = originals[name](*args, **kwargs)
            k1 = launch_counts(before)["logmel"]
            if k1 != 1:
                raise SystemExit(f"fit: {name} launched K1 {k1} times")
            calls[name] += 1
            return out
        return call

    root = tempfile.mkdtemp(prefix="mmav_fit_")
    try:
        t0 = time.perf_counter()
        dirs = write_synthetic_corpus(os.path.join(root, "corpus"), tok, n_videos=8,
                                      sentences_per_video=6, sentence_dur=(3.0, 4.2), seed=0)
        nbytes = sum(os.path.getsize(os.path.join(d, n)) for d in dirs.values()
                     for n in os.listdir(d))
        entries, _ = build_data_list(dirs["json_folder"], dirs["npy_dir"], dirs["text_dir"],
                                     dirs["wav_dir"])
        train_set, val_set, _ = train_val_test_split(entries, seed=Config().data.seed)
        speakers = sorted({speaker_id_of(e.text_path) for e in val_set})
        log(f"[fit] corpus in the AI-Hub layout: {len(entries)} sentences of 3.0-4.2 s (8 "
            f"speakers x 6; 48 kHz wavs, uint8 [T, 128, 128, 3] crops), {nbytes / 1e6:.0f} MB "
            f"written in {time.perf_counter() - t0:.1f} s; split {len(train_set)} train, "
            f"{len(val_set)} val over {len(speakers)} speakers")
        if len(speakers) < 2:
            raise SystemExit("fit: the val split needs two speakers for the fixed eval pairs")
        ckpt = os.path.join(root, "ckpt")
        vocab = os.path.join(REPO, Config().data.vocab_path)
        common = ([f"data.{k}={v}" for k, v in dirs.items()]
                  + [f"data.vocab_path={vocab}", "train.batch_size=8", "train.eval_batch_size=4",
                     "data.num_pairs_per_epoch=32", "data.eval_pairs=8",
                     "train.async_checkpoint=true", "--device=cuda"])

        def run(tag, args, k2_per_call=2):
            """One CLI call, its seconds, peak memory, output and launches."""
            for k in calls:
                calls[k] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tee = _Tee(sys.stdout)
            since = launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee):
                cli.main(args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            k1, k2, k3, k4 = launch_counts(since).values()
            n = sum(calls.values())
            k4_want = 4 * calls["train_step"] + 2 * (calls["eval_step"] + calls["transcribe"])
            log(f"[fit] {tag}: {dt:.1f} s; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {calls['train_step']} "
                f"train steps, {calls['eval_step']} eval batches, {calls['transcribe']} infer "
                f"batches; launches K1 {k1}, K2 {k2} ({k1 / max(n, 1):g} and "
                f"{k2 / max(n, 1):g} per call), K3 {k3}, K4 {k4}")
            if n == 0 or k1 != n or k2 != k2_per_call * n or k4 != k4_want:
                raise SystemExit(f"fit: {tag}: launches K1 {k1}, K2 {k2}, K4 {k4} over {n} "
                                 f"calls (expected 1 and {k2_per_call} per call; K4 4 a train "
                                 f"step, 2 an eval or infer batch: {k4_want})")
            return "".join(tee.text), k1, k2, k3, k4

        def epochs(text):
            rows = []
            for line in text.splitlines():
                if line.startswith("[epoch "):
                    kv = dict(f.split("=", 1) for f in line.split()[2:])
                    rows.append((int(line.split()[1].rstrip("]")), float(kv["train_loss"]),
                                 float(kv["eval_loss"]), float(kv["utt/s"]),
                                 float(kv["input_wait"].rstrip("s")),
                                 float(kv["first_batch_wait"].rstrip("s")),
                                 float(kv["train_s"])))
            return rows

        for cls, name in wrapped:
            setattr(cls, name, counting(name))
        launches = {"logmel": 0, "lip_preprocess": 0, "prefix_beam": 0, "lstm_scan": 0}
        rows = []
        try:
            for tag, extra, k2_per_call in (
                    ("train, 2 epochs", [f"train.checkpoint_dir={ckpt}", "train.max_epochs=2"], 2),
                    ("resume to epoch 3", [f"train.checkpoint_dir={ckpt}", "train.max_epochs=3"], 2),
                    ("--eval", [f"train.checkpoint_dir={ckpt}", "--eval"], 2),
                    ("--infer", [f"train.checkpoint_dir={ckpt}", "--infer"], 2),
                    ("--synthetic, 1 epoch of 16 pairs",
                     [f"train.checkpoint_dir={os.path.join(root, 'synthetic')}", "--synthetic",
                      "train.max_epochs=1", "data.num_pairs_per_epoch=16"], 0),
                    # One epoch of 16 steps from disk: its wait past the first
                    # batch says whether loading keeps up with the steps.
                    ("train, 1 epoch of 128 pairs",
                     [f"train.checkpoint_dir={os.path.join(root, 'long')}", "train.max_epochs=1",
                      "data.num_pairs_per_epoch=128"], 2)):
                text, k1, k2, k3, k4 = run(tag, common + extra, k2_per_call)
                launches = add_launches(launches, (k1, k2, k3, k4))
                rows += [(tag,) + r for r in epochs(text)]
                if tag == "resume to epoch 3" and "at epoch 3" not in text:
                    raise SystemExit("fit: the second call did not resume at epoch 3")
                if tag == "--eval":
                    report = json.loads(text.strip().splitlines()[-1])
                    if set(report["decode"]) != {"greedy", "prefix_beam"}:
                        raise SystemExit(f"fit: --eval report {report}")
                if tag == "--infer":
                    lines = [ln for ln in text.splitlines() if ln.startswith("[utt ")]
                    if len(lines) != 16 or "transcribed 8 pairs" not in text:
                        raise SystemExit(f"fit: --infer printed {len(lines)} transcript lines")
        finally:
            for (cls, name) in wrapped:
                setattr(cls, name, originals[name])

        with open(os.path.join(ckpt, "eval_log.csv")) as f:
            eval_rows = f.read().split()[1:]
        last = torch.load(os.path.join(ckpt, "last.ckpt"), map_location="cpu",
                          weights_only=True)["epoch"]
        for tag, epoch, train_loss, eval_loss, ups, wait, first, train_s in rows:
            rest = train_s - first
            log(f"[fit] {tag}, epoch {epoch}: train_loss {train_loss:.4f}, eval_loss "
                f"{eval_loss:.4f}, {ups:.2f} utt/s (fit's own rate: utterances over the epoch's "
                f"wall time, loading included), waiting on the input {wait:.3f} s of "
                f"{train_s:.3f} s: the first batch {first:.3f} s, the others {wait - first:.3f} s "
                f"({(wait - first) / max(rest, 1e-9):.3f} of the epoch past the first batch)")
        if len(rows) != 5 or not all(math.isfinite(r[2]) and math.isfinite(r[3]) for r in rows):
            raise SystemExit(f"fit: epochs {rows}")
        if len(eval_rows) != 3 or last != 3:
            raise SystemExit(f"fit: eval_log.csv rows {eval_rows}, last.ckpt epoch {last}")
        log(f"[fit] 3 epochs from disk, eval_log.csv rows {len(eval_rows)}, last.ckpt at epoch "
            f"{last}; launches over the phase K1 {launches['logmel']}, K2 "
            f"{launches['lip_preprocess']}, K3 {launches['prefix_beam']}, K4 "
            f"{launches['lstm_scan']}; card {smi}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def k1_at(torch, x, tag: str) -> float:
    """K1 on the card against its plain version on ``x`` (phase 3's bars),
    then its time by graph replay beside its bytes bound; returns the error."""
    from multimodal_av_model_tpu_torch.ops import logmel

    got, ref = logmel.log_mel_spectrogram_cuda(x), logmel.log_mel_spectrogram(x)
    err = (got - ref).abs().max().item()
    if not torch.allclose(got, ref, rtol=2e-3, atol=2e-3):
        raise SystemExit(f"{tag}: K1 disagrees with its plain version at {tuple(x.shape)}: {err}")
    ms = cuda_ms(logmel.log_mel_spectrogram_cuda, [(x,)], 50, graph=True)
    b_ms, b_by = bound(0.0, x.numel() * 4 + got.numel() * 4)
    log(f"[{tag}] K1 {tuple(x.shape)} -> {tuple(got.shape)}: max|kernel-plain| {err:.3g} "
        f"(rtol=atol=2e-3) ok; {ms:.4f} ms by graph replay, bound {b_ms:.4f} ms by {b_by} "
        f"({b_ms / ms:.3f} of it)")
    return err


def _waveform(rng, n: int):
    """A voiced-looking test waveform: two drifting tones and noise."""
    t = np.arange(n) / 16000.0
    f0 = rng.uniform(100, 250)
    return (0.3 * np.sin(2 * np.pi * f0 * t * (1 + 0.1 * np.sin(t)))
            + 0.1 * np.sin(2 * np.pi * 3 * f0 * t) + 0.05 * rng.standard_normal(n)).astype(
        np.float32)


def beam_ref_phase(torch, served) -> None:
    """[beam-ref]: decode.algorithm="reference_beam" on one bucket-128
    request of phase 5; the card's ids against a CPU run of the port's
    reference beam on the same log-probs."""
    import copy

    from multimodal_av_model_tpu_torch.infer import Transcriber, decode_ids

    transcriber, requests = served[:2]
    cfg = copy.deepcopy(transcriber.config)
    cfg.decode.algorithm = "reference_beam"
    ref_t = Transcriber(cfg, transcriber.tokenizer, transcriber.model, device="cuda")
    batch = _flagship_batch(torch, requests[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    texts = ref_t.transcribe(batch)
    torch.cuda.synchronize()
    req_ms = (time.perf_counter() - t0) * 1e3
    keys = ("lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")
    with torch.no_grad():
        out = ref_t.forward(*[torch.as_tensor(batch[k]).cuda() for k in keys])
    lp = torch.cat([out["log_probs1"], out["log_probs2"]])
    lens = torch.cat([out["input_lengths1"], out["input_lengths2"]])
    decode_ids(cfg, lp, lens)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, n = decode_ids(cfg, lp, lens)
    ids, n = ids.cpu(), n.cpu()
    dec_ms = (time.perf_counter() - t0) * 1e3
    ids_cpu, n_cpu = decode_ids(cfg, lp.cpu(), lens.cpu())
    same = torch.equal(ids, ids_cpu) and torch.equal(n, n_cpu)
    log(f"[beam-ref] reference beam (width {cfg.decode.beam_width}) on one bucket-128 request: "
        f"request {req_ms:.1f} ms, decode of {tuple(lp.shape)} log-probs + readback "
        f"{dec_ms:.1f} ms on the card; ids {'equal to' if same else 'DIFFER from'} the CPU run "
        f"of the same log-probs (mean length {n.float().mean().item():.1f}); first texts "
        f"{json.dumps(texts[0])[:80]} {'ok' if same else 'FAILED'}")
    if not same:
        raise SystemExit("beam-ref: the card's reference-beam ids differ from the CPU's")


def quant_phase(torch, served) -> dict:
    """[quant]: the int8 Transcriber on phase 5's requests (K2 x2 and K1 x1
    each): dequantization exact, bytes, latency, agreement with fp ids."""
    import copy

    from multimodal_av_model_tpu_torch import infer
    from multimodal_av_model_tpu_torch.ops import launch_counts

    fp_t, requests, plan = served[:3]
    t0 = time.perf_counter()
    q_t = infer.Transcriber(fp_t.config, fp_t.tokenizer, copy.deepcopy(fp_t.model),
                            device="cuda", quantize=True)
    q = q_t.forward
    build_s = time.perf_counter() - t0
    fp_bytes = sum(v.numel() * 4 for v in fp_t.model.state_dict().values())
    mismatched = [name for name, d in q.dequantized().items() if name in q.scales and not
                  torch.equal(d.cpu(), (q.qstate[name].cpu().reshape(q.layouts[name].view)
                                        .float() * q.scales[name].cpu()).reshape(d.shape)
                              .to(q.dtype))]
    if mismatched:
        raise SystemExit(f"quant: dequantization on the card differs from the plain one: "
                         f"{mismatched[:5]}")
    log(f"[quant] {len(q.scales)} of {len(q.qstate)} tensors int8 (min_size 4096), quantized "
        f"on the card in {build_s:.2f} s; every dequantized tensor equals the plain "
        f"(q.float() * s).to({q.dtype}) on the CPU ok; parameters held {q.nbytes / 1e6:.1f} MB "
        f"(int8 + scales + unquantized) against {fp_bytes / 1e6:.1f} MB f32 "
        f"({fp_bytes / 2 / 1e6:.1f} MB as bf16): {fp_bytes / q.nbytes:.2f}x and "
        f"{fp_bytes / 2 / q.nbytes:.2f}x smaller")

    decoded, original = {}, infer.decode_ids

    def recording(tag):
        def decode(*args, **kwargs):
            ids, n = original(*args, **kwargs)
            decoded.setdefault(tag, []).extend(
                ids[b, :k].tolist() for b, k in enumerate(n.cpu().tolist()))
            return ids, n
        return decode

    for raw in requests[:1]:                        # warm-up of the int8 path
        q_t.transcribe(_flagship_batch(torch, raw))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    since = launch_counts()
    lat, per_request = [], []
    try:
        infer.decode_ids = recording("int8")
        for raw in requests:                        # the main path
            before = launch_counts()
            t0 = time.perf_counter()
            q_t.transcribe(_flagship_batch(torch, raw))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            per_request.append(tuple(launch_counts(before).values()))
        launches = launch_counts(since)
        peak = torch.cuda.max_memory_allocated()
        infer.decode_ids = recording("fp")
        for raw in requests:                        # the fp texts, not counted
            fp_t.transcribe(_flagship_batch(torch, raw))
    finally:
        infer.decode_ids = original
    if any(p != (1, 2, 1, 2) for p in per_request):
        raise SystemExit(f"quant: launches per request {per_request} (expected K1 1, K2 2, "
                         f"K3 1, K4 2)")
    pairs = list(zip(decoded["int8"], decoded["fp"]))
    same_seq = sum(a == b for a, b in pairs) / len(pairs)
    agree = sum(sum(x == y for x, y in zip(a, b)) for a, b in pairs) / max(
        sum(max(len(a), len(b)) for a, b in pairs), 1)
    log(f"[quant] {len(requests)} requests (buckets {plan}): "
        + ", ".join(f"{ms:.1f}" for ms in lat) + f" ms; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches} (K1 1, K2 2, K3 1, K4 2 per request); "
        f"against "
        f"the fp "
        f"Transcriber on the same requests: {same_seq:.3f} of the {len(pairs)} id sequences "
        f"equal, {agree:.3f} of the id positions agree (reported, not gated)")
    del q_t
    return launches


def stream_ref_phase(torch, rng, tok) -> None:
    """[stream-ref]: the pairing gates in f32 at a small width on the card
    (in bf16 at full width a row's argmax may move with its batch
    neighbours, as cuBLAS picks kernels by batch size): three pooled streams
    equal three single-stream runs; every ``AudioService`` answer equals a
    direct transcription of the request at the service's shape."""
    from multimodal_av_model_tpu_torch.infer import AudioTranscriber
    from multimodal_av_model_tpu_torch.models import AudioOnlyCTC, init_weights
    from multimodal_av_model_tpu_torch.serve import AudioService
    from multimodal_av_model_tpu_torch.streaming import StreamingAudioTranscriber, StreamingPool

    cfg = tiny_model_config()
    model = init_weights(AudioOnlyCTC(cfg.model), torch.Generator().manual_seed(3))
    kw = dict(chunk_seconds=0.5, context_seconds=1.0, device="cuda")
    audios = [_waveform(rng, n) for n in (30000, 21000, 40000)]
    blocks = (4000, 7000, 16000)
    pool = StreamingPool(cfg, tok, model, max_streams=4, **kw)
    sids = [pool.open() for _ in audios]
    pooled = [""] * 3
    for step in range(max(len(a) // b + 1 for a, b in zip(audios, blocks))):
        for j, sid in enumerate(sids):
            lo = step * blocks[j]
            if lo < len(audios[j]):
                pooled[j] += pool.feed(sid, audios[j][lo:lo + blocks[j]])
    pooled = [p + pool.flush(sid) for p, sid in zip(pooled, sids)]
    single = []
    for a, b in zip(audios, blocks):
        s = StreamingAudioTranscriber(cfg, tok, model, algorithm="greedy", **kw)
        single.append("".join(s.feed(a[i:i + b]) for i in range(0, len(a), b)) + s.flush())
    t = AudioTranscriber(cfg, tok, model, device="cuda")
    svc = AudioService(t, max_batch=4, max_seconds=1.0, max_wait_ms=20)
    waves = [_waveform(rng, int(rng.integers(4000, 20000))) for _ in range(9)]
    answers = [f.result(120) for f in [svc.submit(w) for w in waves]]
    svc.close()
    direct = []
    for w in waves:
        audio, mask = np.zeros((4, svc.samples), np.float32), np.zeros((4, svc.samples), bool)
        audio[0, :min(len(w), svc.samples)] = w[:svc.samples]
        mask[0, :min(len(w), svc.samples)] = True
        direct.append(t.transcribe(audio, mask)[0])
    ok = pooled == single and answers == direct
    log(f"[stream-ref] small f32 audio model on the card: 3 pooled streams "
        f"{'equal' if pooled == single else 'DIFFER from'} 3 single-stream runs "
        f"({sum(map(len, single))} characters); {len(waves)} service answers "
        f"{'equal' if answers == direct else 'DIFFER from'} direct transcriptions "
        f"(mean batch {svc.batcher.stats.mean_batch:.2f}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"stream-ref: pooled {pooled} single {single} / answers {answers} "
                         f"direct {direct}")


def _split_ms(torch, forward, decode) -> tuple[float, float]:
    """Host-clock ms of ``forward()`` and of ``decode(its output)``, each
    ended by a synchronise (after one warm-up of both)."""
    with torch.no_grad():
        decode(forward())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode(out)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3


def _audio_model(torch):
    """``AudioOnlyCTC`` on the flagship's 12x512 Conformer, vocab 800, bf16,
    seeded random weights."""
    from multimodal_av_model_tpu_torch.config import Config, torch_dtype
    from multimodal_av_model_tpu_torch.models import AudioOnlyCTC, init_weights

    cfg = Config()
    model = init_weights(AudioOnlyCTC(cfg.model, torch_dtype(cfg.model.dtype)),
                         torch.Generator().manual_seed(4))
    return cfg, model


def stream_audio_phase(torch, rng, tok):
    """[stream-audio]: 30 s through ``StreamingAudioTranscriber`` in 2 s
    chunks (8 s context, prefix beam), then 8 streams of 20 s through a
    ``StreamingPool``, at full width."""
    from multimodal_av_model_tpu_torch.ops import launch_counts
    from multimodal_av_model_tpu_torch.streaming import (
        StreamingAudioTranscriber,
        StreamingPool,
        _PrefixBeamStream,
    )

    cfg, model = _audio_model(torch)
    n_params = sum(p.numel() for p in model.parameters())
    s = StreamingAudioTranscriber(cfg, tok, model, chunk_seconds=2.0, context_seconds=8.0,
                                  device="cuda", algorithm="prefix_beam")
    x = torch.from_numpy(np.stack([_waveform(rng, s.window_samples) for _ in range(8)])).cuda()
    k1_at(torch, x[:1].contiguous(), "stream-audio")
    k1_at(torch, x, "stream-audio")
    del x
    bad = []

    def check(mod, args, out):                       # finite, normalised log-probs
        lp = out[0].float()
        if not torch.isfinite(lp).all() or (lp.logsumexp(-1).abs() > 1e-3).any():
            bad.append(tuple(lp.shape))
    hook = model.register_forward_hook(check)
    audio = _waveform(rng, 30 * 16000)
    block = s.chunk_samples
    s.feed(audio[:block])                            # warm-up, then a fresh stream
    s.flush()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    since = launch_counts()
    lat, text = [], ""
    for i in range(0, len(audio), block):            # the main path
        t0 = time.perf_counter()
        text += s.feed(audio[i:i + block])
        lat.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    text += s.flush()
    flush_ms = (time.perf_counter() - t0) * 1e3
    k1, _, k3, k4 = launch_counts(since).values()
    peak = torch.cuda.max_memory_allocated()
    launches = {"stream_audio": {"logmel": k1, "lip_preprocess": 0, "prefix_beam": k3,
                                 "lstm_scan": k4}}
    if k1 != len(lat) or k4 or bad:
        raise SystemExit(f"stream-audio: K1 {k1}, K4 {k4} launches for {len(lat)} windows, bad "
                         f"log-probs {bad}")
    log(f"[stream-audio] AudioOnlyCTC {n_params / 1e6:.1f}M params (bf16 compute), window "
        f"[1, {s.window_samples}] (2 s chunk + 8 s context), prefix beam 5: 30 s in "
        f"{len(lat)} chunks; per-chunk latency (host clock around each feed) min "
        f"{min(lat):.1f}, median {np.median(lat):.1f}, max {max(lat):.1f} ms; flush "
        f"{flush_ms:.1f} ms; real-time factor {(sum(lat) + flush_ms) / 1e3 / 30:.4f}; peak "
        f"device memory {peak / 2**30:.2f} GiB; K1 {k1} launches (1 per window), K3 {k3}; "
        f"finite, "
        f"normalised log-probs ok; {len(text)} characters emitted")
    window = torch.from_numpy(audio[None, :s.window_samples]).cuda()
    spf = cfg.model.frontend.hop_length * cfg.model.audio.subsample_factor
    start, n_new = (s.window_samples - s.chunk_samples) // spf, s.chunk_samples // spf
    beam = _PrefixBeamStream(cfg.decode, cfg.model.decoder.blank_id, n_new, s.beam_capacity)
    fwd_ms, dec_ms = _split_ms(torch, lambda: s.forward_fn(window, torch.ones_like(
        window, dtype=torch.bool)), lambda lp: beam.advance(lp[0], start, start + n_new))
    log(f"[stream-audio] one more window, not counted: forward {fwd_ms:.1f} ms, prefix-beam "
        f"step over its {n_new} new frames + commit readback {dec_ms:.1f} ms")

    pool = StreamingPool(cfg, tok, model, max_streams=8, chunk_seconds=2.0,
                         context_seconds=8.0, device="cuda")
    audios = [_waveform(rng, 20 * 16000) for _ in range(8)]
    sid = pool.open()
    pool.feed(sid, audios[0][:block])                # warm-up
    pool.flush(sid)
    ticks = []
    step = pool._step

    def counting_step(*a, **kw):
        t0 = time.perf_counter()
        active = sum(b is not None and b.shape[0] >= pool.chunk_samples
                     for b, on in zip(pool._buffer, pool._active) if on)
        step(*a, **kw)
        ticks.append((active, time.perf_counter() - t0))
    pool._step = counting_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    since = launch_counts()
    sids = [pool.open() for _ in audios]
    t0 = time.perf_counter()
    n_chars = 0
    for i in range(0, 20 * 16000, block):            # the main path, as the CLI feeds
        for sid, a in zip(sids, audios):
            n_chars += len(pool.feed(sid, a[i:i + block]))
    for sid in sids:
        n_chars += len(pool.flush(sid))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, _, k3, k4 = launch_counts(since).values()
    peak = torch.cuda.max_memory_allocated()
    hook.remove()
    pool._step = step
    launches["pool"] = {"logmel": k1, "lip_preprocess": 0, "prefix_beam": k3, "lstm_scan": k4}
    tick_ms = [dt * 1e3 for _, dt in ticks]
    if k1 != len(ticks) or k4 or bad:
        raise SystemExit(f"pool: K1 {k1}, K4 {k4} launches for {len(ticks)} ticks, bad "
                         f"log-probs {bad}")
    log(f"[stream-audio] pool of 8 streams x 20 s, fed in 2 s blocks stream by stream (as "
        f"the CLI feeds): {len(ticks)} ticks of [8, {pool.window_samples}], "
        f"{sum(a for a, _ in ticks) / len(ticks):.2f} streams per tick; tick min "
        f"{min(tick_ms):.1f}, median {np.median(tick_ms):.1f}, max {max(tick_ms):.1f} ms; "
        f"{wall:.2f} s for 160 s of audio: real-time factor {wall / 160:.4f}; peak device "
        f"memory {peak / 2**30:.2f} GiB; K1 {k1} launches (1 per tick), K3 {k3}; {n_chars} "
        f"characters")
    return launches, (cfg, model)


def serve_phase(torch, rng, tok, audio_model) -> dict:
    """[serve]: ``AudioService(max_batch=8, max_seconds=16)`` over the
    full-width ``AudioTranscriber``, 32 requests of 2-16 s from 32 threads."""
    from concurrent.futures import ThreadPoolExecutor

    from multimodal_av_model_tpu_torch.infer import AudioTranscriber, decode_ids
    from multimodal_av_model_tpu_torch.ops import launch_counts
    from multimodal_av_model_tpu_torch.ops import prefix_beam_search as pbs
    from multimodal_av_model_tpu_torch.serve import AudioService

    cfg, model = audio_model
    t = AudioTranscriber(cfg, tok, model, device="cuda")
    svc = AudioService(t, max_batch=8, max_seconds=16.0, max_wait_ms=10.0)
    x = torch.from_numpy(np.stack([_waveform(rng, svc.samples) for _ in range(8)])).cuda()
    k1_at(torch, x, "serve")
    del x
    svc.transcribe(_waveform(rng, 16000), timeout=300)     # warm-up
    waves = [_waveform(rng, int(rng.uniform(2, 16) * 16000)) for _ in range(32)]
    base = svc.batcher.stats.requests, svc.batcher.stats.batches

    def call(w):
        t0 = time.perf_counter()
        text = svc.transcribe(w, timeout=300)
        return text, (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    since = launch_counts()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=32) as ex:              # the main path
        results = list(ex.map(call, waves))
    wall = time.perf_counter() - t0
    k1, _, k3, k4 = launch_counts(since).values()
    peak = torch.cuda.max_memory_allocated()
    svc.close()
    n_req = svc.batcher.stats.requests - base[0]
    n_batches = svc.batcher.stats.batches - base[1]
    lat = sorted(ms for _, ms in results)
    p50, p90 = float(np.percentile(lat, 50)), float(np.percentile(lat, 90))
    if len(results) != 32 or n_req != 32 or not all(isinstance(x, str) for x, _ in results) \
            or k1 != n_batches or k4:
        raise SystemExit(f"serve: {len(results)} answers, {n_req} requests counted, K1 {k1}, "
                         f"K4 {k4} launches for {n_batches} batches")
    batch = torch.from_numpy(np.stack([_waveform(rng, svc.samples) for _ in range(8)])).cuda()
    mask = torch.ones_like(batch, dtype=torch.bool)
    fwd_ms, dec_ms = _split_ms(torch, lambda: t.forward(batch, mask),
                               lambda out: decode_ids(cfg, *out))
    with torch.no_grad():
        lp, lengths = t.forward(batch, mask)
    dcfg = cfg.decode
    args = (lp, lengths, None, None, None, None, None, dcfg.beam_width, dcfg.prefix_top_k,
            cfg.model.decoder.blank_id, -1, 0.0, 0.0)
    agree, err = k3_agrees(pbs.prefix_beam_op(*args), pbs._prefix_beam_plain(*args))
    log(f"[serve] K3 on that batch's log-probs {tuple(lp.shape)} {lp.dtype}, lengths "
        f"{lengths.tolist()}: ids, lengths and prefixes {'equal to' if agree else 'DIFFER from'} "
        f"the plain loop's, max|score, pb, pnb - plain| = {err:.3g} "
        f"{'ok' if agree else 'FAILED'}")
    if not agree:
        raise SystemExit("serve: K3 disagrees with the plain loop on the service batch")
    log(f"[serve] AudioService(max_batch=8, max_seconds=16) over AudioTranscriber (12x512, "
        f"bf16, prefix beam 5): 32 requests of 2-16 s from 32 threads, all answered in "
        f"{wall:.2f} s; {n_batches} batches of [8, {svc.samples}], mean batch "
        f"{n_req / n_batches:.2f}; latency per request p50 {p50:.1f} ms, p90 {p90:.1f} ms "
        f"({sum(ms > p90 for ms in lat)} beyond it), max {lat[-1]:.1f}; peak device memory "
        f"{peak / 2**30:.2f} GiB; K1 {k1} launches (1 per batch), K3 {k3}; one more full "
        f"batch, not "
        f"counted: forward {fwd_ms:.1f} ms, prefix-beam decode of its {svc.samples // 320 + 1} "
        f"frames + readback {dec_ms:.1f} ms")
    return {"logmel": k1, "lip_preprocess": 0, "prefix_beam": k3, "lstm_scan": k4}


def stream_av_phase(torch, tok, smi: str) -> dict:
    """[stream-av]: the port's CLI ``--stream=lips1.avi,lips2.avi,mix.wav`` on
    a full-width flagship checkpoint the port writes, with 12 s of media
    written by the port's ``write_avi`` and ``write_wav``; the streamed
    prefix-beam ids of each speaker against one offline pass over the
    emitted log-probs."""
    import contextlib
    import shutil
    import tempfile

    from multimodal_av_model_tpu_torch import main as cli
    from multimodal_av_model_tpu_torch import streaming
    from multimodal_av_model_tpu_torch.config import Config, torch_dtype
    from multimodal_av_model_tpu_torch.data.audio_io import write_wav
    from multimodal_av_model_tpu_torch.data.avi import write_avi
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel, init_weights
    from multimodal_av_model_tpu_torch.ops import launch_counts
    from multimodal_av_model_tpu_torch.ops import prefix_beam_search as pbs
    from multimodal_av_model_tpu_torch.ops.prefix_beam_search import prefix_beam_search_decode
    from multimodal_av_model_tpu_torch.train import save_checkpoint

    cfg = Config()
    root = tempfile.mkdtemp(prefix="mmav_stream_av_")
    rng = np.random.default_rng(6)
    try:
        t0 = time.perf_counter()
        model = init_weights(MultiSpeakerAVModel(cfg.model, torch_dtype(cfg.model.dtype)),
                             torch.Generator().manual_seed(0))
        save_checkpoint(os.path.join(root, "ckpt", "last.ckpt"),
                        {"state": {"model": model.state_dict()}, "epoch": 0})
        del model
        n_f, spf = 360, cfg.data.audio_samples_per_video_frame
        media = [os.path.join(root, f) for f in ("lips1.avi", "lips2.avi", "mix.wav")]
        for path in media[:2]:
            yy, xx = np.mgrid[0:128, 0:128]
            frames = np.stack([np.clip(128 + 60 * np.sin(xx / (9 + 3 * np.sin(f / 7)) + f / 5)
                                       * np.cos(yy / 11) + rng.normal(0, 8, (128, 128)), 0, 255)
                               for f in range(n_f)]).astype(np.uint8)
            write_avi(path, np.repeat(frames[..., None], 3, -1), fps=30)
        write_wav(media[2], _waveform(rng, n_f * spf), 16000)
        log(f"[stream-av] full-width flagship checkpoint and 12 s of media ({n_f} frames of "
            f"128x128x3 in two DIB AVIs, a 16 kHz WAV) written by the port in "
            f"{time.perf_counter() - t0:.1f} s")

        F = round(2.0 * 16000 / spf) + round(8.0 * 16000 / spf)
        x = torch.from_numpy(_waveform(rng, F * spf)[None]).cuda()
        k1_at(torch, x, "stream-av")
        del x

        emitted, tails, window_ms, steps = {}, {}, [], []
        advance, tail, decode_window = (streaming._PrefixBeamStream.advance,
                                        streaming._PrefixBeamStream.tail,
                                        streaming.StreamingAVTranscriber._decode_window)
        stream_step = streaming.prefix_beam_stream_step

        def rec_step(state, log_probs, length, **kw):
            """K3 on the carried state (C = the stream's capacity); its inputs
            and outputs kept for the plain loop after the call."""
            out = stream_step(state, log_probs, length, **kw)
            steps.append((tuple(x.clone() for x in state), log_probs.clone(), int(length), kw,
                          tuple(x.clone() for x in out)))
            return out

        def rec_advance(self, log_probs, start, end):
            out = advance(self, log_probs, start, end)
            rows, ids = emitted.setdefault(id(self), ([], []))
            rows.append(log_probs[start:end].float().cpu())
            ids.extend(out)
            return out

        def rec_tail(self):
            out = tail(self)
            tails[id(self)] = out
            return out

        def timed_window(self, valid_f):
            t0 = time.perf_counter()
            out = decode_window(self, valid_f)
            torch.cuda.synchronize()
            window_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        args = [f"--stream={','.join(media)}", f"train.checkpoint_dir={os.path.join(root, 'ckpt')}",
                f"data.vocab_path={os.path.join(REPO, cfg.data.vocab_path)}", "--device=cuda"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        since = launch_counts()
        tee = _Tee(sys.stdout)
        streaming._PrefixBeamStream.advance = rec_advance
        streaming._PrefixBeamStream.tail = rec_tail
        streaming.StreamingAVTranscriber._decode_window = timed_window
        streaming.prefix_beam_stream_step = rec_step
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee), k4_recording() as k4_calls:  # the main path
                cli.main(args)
            torch.cuda.synchronize()
            call_s = time.perf_counter() - t0
        finally:
            streaming._PrefixBeamStream.advance = advance
            streaming._PrefixBeamStream.tail = tail
            streaming.StreamingAVTranscriber._decode_window = decode_window
            streaming.prefix_beam_stream_step = stream_step
        k1, k2, k3, k4 = launch_counts(since).values()
        peak = torch.cuda.max_memory_allocated()
        n_win = len(window_ms)
        if (n_win == 0 or k1 != n_win or k2 != 0 or len(emitted) != 2 or k3 != len(steps)
                or k4 != 2 * n_win):
            raise SystemExit(f"stream-av: K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4} launches for "
                             f"{n_win} windows, {len(steps)} beam steps, {len(emitted)} beams")
        k4_agrees(torch, k4_calls[0], "stream-av")
        # Each carried-state step of K3 against the plain loop on the same
        # state and log-probs.
        agree, err = True, 0.0
        for state, lp, length, kw, got in steps:
            want = pbs._prefix_beam_plain(
                lp[None], torch.full((1,), length, device=lp.device), *(x[None] for x in state),
                kw["lm"], state[0].shape[0], kw["top_k"], kw["blank_id"], -1, kw["lm_weight"],
                kw["length_bonus"])[:4]
            a, e = k3_agrees(got, tuple(x[0] for x in want))
            agree, err = agree and a, max(err, e)
        log(f"[stream-av] K3's {len(steps)} steps on the carried state (capacity "
            f"{steps[0][0][0].shape[1]}, {steps[0][1].shape[0]} frames a step, "
            f"{steps[0][1].dtype}): prefixes and lengths {'equal to' if agree else 'DIFFER from'} "
            f"the plain loop's on the same state and log-probs, max|pb, pnb - plain| = {err:.3g} "
            f"{'ok' if agree else 'FAILED'}")
        if not agree:
            raise SystemExit("stream-av: K3 disagrees with the plain loop on the carried state")
        dcfg, same = cfg.decode, []
        for key, (rows, ids) in emitted.items():
            lp = torch.cat(rows)
            want, n, _ = prefix_beam_search_decode(lp[None].cuda(), torch.tensor([lp.shape[0]]),
                                                   dcfg.beam_width, dcfg.prefix_top_k,
                                                   cfg.model.decoder.blank_id)
            got = ids + tails.get(key, [])
            same.append(got == want[0, :int(n[0])].cpu().tolist())
            if not torch.isfinite(lp).all():
                raise SystemExit("stream-av: non-finite log-probs")
        lines = [ln for ln in "".join(tee.text).splitlines() if ln.startswith("[speaker")]
        log(f"[stream-av] CLI --stream=lips1.avi,lips2.avi,mix.wav in {call_s:.1f} s: {n_win} "
            f"windows of {F} frames (2 s chunk + 8 s context; lips [1, {F}, 1, 96, 96] x 2, "
            f"audio [1, {F * spf}]), per window "
            + ", ".join(f"{ms:.0f}" for ms in window_ms) + f" ms; real-time factor "
            f"{sum(window_ms) / 1e3 / (n_f * spf / 16000):.4f} (windows only); peak device "
            f"memory {peak / 2**30:.2f} GiB; launches K1 {k1}, K2 {k2} (1 and 0 per window), "
            f"K3 {k3} (1 per beam step), K4 {k4} (2 per window); "
            f"{len(lines)} speaker lines; streamed prefix-beam ids "
            f"{'equal' if all(same) else 'DIFFER from'} one offline pass over the emitted "
            f"log-probs for both speakers ({[len(r[1]) + len(tails.get(k, [])) for k, r in emitted.items()]} tokens) "
            f"{'ok' if all(same) else 'FAILED'}; card {smi}")
        if not all(same):
            raise SystemExit("stream-av: streamed ids differ from the offline pass")
        return {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _transcriber_ids(torch, t, batch, use_beam: bool = True):
    """``t``'s decoded ids and lengths for ``batch``, both speakers as one
    ``[2B]`` batch, as ``Transcriber.transcribe`` decodes them."""
    from multimodal_av_model_tpu_torch.infer import _BATCH_KEYS, decode_ids

    with torch.no_grad():
        out = t.forward(*[torch.as_tensor(batch[k]).cuda() for k in _BATCH_KEYS])
        return decode_ids(t.config, torch.cat([out["log_probs1"], out["log_probs2"]]),
                          torch.cat([out["input_lengths1"], out["input_lengths2"]]), use_beam,
                          t.lm)


def export_phase(torch, served) -> dict:
    """[export]: phase 5's Transcriber exported at bucket 128 (B = 4) with the
    prefix beam, and its int8 form with greedy decoding; each artifact loaded
    back and run on phase 5's three bucket-128 requests after
    ``preprocess_batch_device`` (K2 x2): ids equal to the Transcriber's, K1
    once and K2 never inside an artifact call."""
    import copy
    import shutil
    import tempfile

    from multimodal_av_model_tpu_torch.infer import (
        _BATCH_KEYS,
        ExportedTranscriber,
        Transcriber,
        export_transcriber,
    )
    from multimodal_av_model_tpu_torch.ops import launch_counts

    fp_t, requests, plan, serving_lat = served
    chosen = [i for i, T in enumerate(plan) if T == 128]
    serving_ms = [serving_lat[i] * 1e3 for i in chosen]
    q_t = Transcriber(fp_t.config, fp_t.tokenizer, copy.deepcopy(fp_t.model), device="cuda",
                      quantize=True)
    root = tempfile.mkdtemp(prefix="mmav_export_")
    launches = {"logmel": 0, "lip_preprocess": 0, "prefix_beam": 0, "lstm_scan": 0}
    try:
        for name, t, use_beam in (("prefix beam 5, top-k 8", fp_t, True),
                                  ("int8, greedy", q_t, False)):
            out_dir = os.path.join(root, "int8" if t is q_t else "fp")
            example = _flagship_batch(torch, requests[chosen[0]])
            torch.cuda.synchronize()
            report = export_transcriber(t, out_dir, example, use_beam=use_beam)
            files = {f: os.path.getsize(os.path.join(out_dir, f)) for f in os.listdir(out_dir)}
            t0 = time.perf_counter()
            artifact = ExportedTranscriber.load(out_dir, device="cuda")
            load_s = time.perf_counter() - t0
            weights = sum(x.numel() * x.element_size()
                          for x in artifact.program.state_dict.values())
            artifact.transcribe(example)                 # warm-up
            torch.cuda.synchronize()
            since = launch_counts()
            lat, batches, inside = [], [], []
            for i in chosen:                             # the main path
                t0 = time.perf_counter()
                batch = _flagship_batch(torch, requests[i])
                before = launch_counts()
                texts = artifact.transcribe(batch)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
                inside.append(tuple(launch_counts(before).values()))
                batches.append(batch)
                if len(texts) != 4:
                    raise SystemExit(f"export: {len(texts)} texts for a request of 4")
            k1, k2, k3, k4 = launch_counts(since).values()
            launches = add_launches(launches, (k1, k2, k3, k4))
            same = []
            for batch in batches:
                with torch.no_grad():
                    ids1, len1, ids2, len2 = artifact.module(
                        artifact.lm, *[torch.as_tensor(batch[k]).cuda() for k in _BATCH_KEYS])
                want_ids, want_len = _transcriber_ids(torch, t, batch, use_beam)
                same.append(torch.equal(torch.cat([ids1, ids2]), want_ids)
                            and torch.equal(torch.cat([len1, len2]), want_len))
            ok = (all(same) and all(p == (1, 0, int(use_beam), 2) for p in inside)
                  and k2 == 2 * len(chosen))
            log(f"[export] {name}: torch.export of forward + decode at bucket 128, B=4 in "
                f"{report['seconds']:.1f} s, {report['nodes']} graph nodes; artifact "
                + ", ".join(f"{f} {b / 1e6:.1f} MB" for f, b in sorted(files.items()))
                + f" (weights and buffers {weights / 1e6:.1f} MB of it, the rest the "
                f"graph); loaded in {load_s:.1f} s; {len(chosen)} bucket-128 requests "
                f"(preprocess_batch_device + ExportedTranscriber.transcribe): "
                + ", ".join(f"{ms:.1f}" for ms in lat) + " ms against [serving]'s "
                + ", ".join(f"{ms:.1f}" for ms in serving_ms) + f" ms; launches inside the "
                f"artifact calls (K1, K2, K3, K4) {inside}, over the path K1 {k1}, K2 {k2}, K3 "
                f"{k3}, K4 {k4}; ids "
                f"{'equal to' if all(same) else 'DIFFER from'} the Transcriber's "
                f"({sum(same)} of {len(same)} requests) {'ok' if ok else 'FAILED'}")
            if not ok:
                raise SystemExit(f"export: {name}: ids equal {same}, launches per artifact "
                                 f"call {inside}, K2 {k2}")
            del artifact
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
        del q_t


def temporal_tf_phase(torch, rng, tok) -> dict:
    """[temporal-tf]: the flagship with ``fusion.temporal_model=
    "transformer"`` (2 layers, 8 heads, FFN 2048): a small f32 check card
    against CPU, three bucket-128 requests (K1 x1, K2 x2 each) with one more
    timed by layer, then B = 8 training steps at ``bench.py``'s shapes."""
    from multimodal_av_model_tpu_torch.config import Config, torch_dtype
    from multimodal_av_model_tpu_torch.data.collate import make_bucket_specs
    from multimodal_av_model_tpu_torch.infer import Transcriber
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel, init_weights
    from multimodal_av_model_tpu_torch.ops import launch_counts

    reference_phase(torch, rng, "transformer", "temporal-tf")
    cfg = Config()
    cfg.model.fusion.temporal_model = "transformer"
    f = cfg.model.fusion
    model = init_weights(MultiSpeakerAVModel(cfg.model, torch_dtype(cfg.model.dtype)),
                         torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    transcriber = Transcriber(cfg, tok, model, device="cuda")
    spec = make_bucket_specs((128,), cfg.data.audio_samples_per_video_frame,
                             cfg.data.max_label_len)[0]
    requests = [make_request(rng, 4, spec) for _ in range(3)]

    def serve(raw):
        return transcriber.transcribe(_flagship_batch(torch, raw))

    serve(requests[0])                               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    since = launch_counts()
    lat, per_request = [], []
    for raw in requests:                             # the main path
        before = launch_counts()
        t0 = time.perf_counter()
        texts = serve(raw)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        per_request.append(tuple(launch_counts(before).values()))
        if len(texts) != 4:
            raise SystemExit(f"temporal-tf: {len(texts)} texts for a request of 4")
    launches = launch_counts(since)
    peak = torch.cuda.max_memory_allocated()
    if any(p != (1, 2, 1, 0) for p in per_request):
        raise SystemExit(f"temporal-tf: launches per request {per_request} (expected 1, 2, "
                         f"1 and 0)")
    log(f"[temporal-tf] flagship with the transformer temporal model ({f.temporal_layers} layers, "
        f"{f.transformer_heads} heads, FFN {f.transformer_ffn_dim}), {n_params / 1e6:.1f}M params, "
        f"bf16: 3 bucket-128 requests of 4 "
        + ", ".join(f"{ms:.1f}" for ms in lat) + f" ms; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches per request {per_request}")
    traced(torch, "temporal-tf", "one bucket-128 request", lambda: serve(requests[0]))
    del transcriber, model
    train_launches, _ = train_phase(torch, rng, tok, runs=((8, "none", 5),),
                                    temporal_model="transformer", tag="temporal-tf")
    return {k: launches[k] + train_launches[k] for k in launches}


def structured_phase(torch, tok, smi: str) -> dict:
    """[structured]: a small AI-Hub corpus written by the port, validated
    with one lip file corrupted on purpose (it must be skipped with its
    reason), its sentences read back, and the transformer flagship trained
    20 steps at B = 8 on ``RealTextStructuredSource`` batches (K1 1, K2 0
    per step: the source makes preprocessed lips); then the
    nearest-centroid overlap-vs-solo probe on its contrastive features."""
    import shutil
    import tempfile

    from multimodal_av_model_tpu_torch.config import Config, torch_dtype
    from multimodal_av_model_tpu_torch.data.collate import make_bucket_specs
    from multimodal_av_model_tpu_torch.data.manifest import build_data_list
    from multimodal_av_model_tpu_torch.data.pipeline import bucketed_batches
    from multimodal_av_model_tpu_torch.data.structured import (
        RealTextStructuredSource,
        load_reference_sentences,
    )
    from multimodal_av_model_tpu_torch.data.synth_corpus import write_synthetic_corpus
    from multimodal_av_model_tpu_torch.data.validate import validate_manifest
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
    from multimodal_av_model_tpu_torch.ops import launch_counts
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer
    from multimodal_av_model_tpu_torch.train.probe import (
        collect_frame_features,
        nearest_centroid_probe,
        overlap_vs_solo_labels,
    )

    root = tempfile.mkdtemp(prefix="mmav_structured_")
    try:
        dirs = write_synthetic_corpus(os.path.join(root, "corpus"), tok, n_videos=4,
                                      sentences_per_video=5, sentence_dur=(0.6, 1.2), seed=1)
        entries, _ = build_data_list(dirs["json_folder"], dirs["npy_dir"], dirs["text_dir"],
                                     dirs["wav_dir"])
        broken = entries[3]
        with open(broken.lip_path, "wb") as fh:     # corrupted on purpose
            fh.write(b"not an npy file")
        report = validate_manifest(entries, check_lip_contents=True)
        skipped = [(e.lip_path, r) for e, r in report.skipped]
        if (len(skipped) != 1 or skipped[0][0] != broken.lip_path
                or not skipped[0][1].startswith("unreadable_lip")):
            raise SystemExit(f"structured: validate_manifest skipped {skipped}")
        sentences = load_reference_sentences(dirs["json_folder"])
        if len(sentences) != len(entries):
            raise SystemExit(f"structured: {len(sentences)} sentences for {len(entries)} entries")
        log(f"[structured] corpus of {len(entries)} sentences: validate_manifest "
            f"{report.summary()}, the corrupted lip file skipped as "
            f"{skipped[0][1].split(':')[0]} ok; {len(sentences)} sentences read back, e.g. "
            f"{json.dumps(sentences[0], ensure_ascii=False)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    cfg = Config()
    cfg.model.fusion.temporal_model = "transformer"
    specs = make_bucket_specs(cfg.data.video_buckets, cfg.data.audio_samples_per_video_frame,
                              cfg.data.max_label_len)
    B, n_steps = 8, 20
    src = RealTextStructuredSource(tok, sentences, seed=0, max_chars=12, min_chars=4)

    def batches(n):
        return list(bucketed_batches((src.load_pair() for _ in range(n * B)), specs, B,
                                     drop_last=True))[:n]

    t0 = time.perf_counter()
    trainer = MultiSpeakerTrainer(
        cfg, MultiSpeakerAVModel(cfg.model, torch_dtype(cfg.model.dtype)), tok)
    state = trainer.init_state(cfg.data.seed)
    train_batches = batches(n_steps + 2)
    data_s = time.perf_counter() - t0
    shapes = sorted({b["lip1"].shape[1] for b in train_batches})
    for b in train_batches[:2]:                     # warm-up
        state, _ = trainer.train_step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    since = launch_counts()
    losses = []
    t0 = time.perf_counter()
    for b in train_batches[2:]:                     # the main path
        state, m = trainer.train_step(state, b)
        losses.append(m["loss"])
    losses = [x.item() for x in losses]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, k3, k4 = launch_counts(since).values()
    peak = torch.cuda.max_memory_allocated()
    if k1 != n_steps or k2 != 0 or k4 != 0 or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"structured: K1 {k1}, K2 {k2}, K4 {k4} over {n_steps} steps, losses "
                         f"{losses}")

    outs = []
    with torch.no_grad():
        for b in batches(4):
            placed = trainer._place(b)
            out = state.model.eval()(*[placed[k] for k in (
                "lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")])
            outs.append(out)
    state.model.train()
    feats, labels = collect_frame_features(outs, speaker=1)
    y = overlap_vs_solo_labels(labels)
    acc = nearest_centroid_probe(feats, y)
    log(f"[structured] transformer flagship on RealTextStructuredSource (chords of the "
        f"sentences read back, 4-12 characters, lips made at 96x96): {n_steps} steps at B={B} "
        f"(buckets {shapes}) in {wall:.2f} s, {B * n_steps / wall:.2f} utt/s; batches made in "
        f"{data_s:.1f} s with the model; peak device memory {peak / 2**30:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (min {min(losses):.4f}); launches per step K1 "
        f"{k1 / n_steps:g}, K2 {k2 / n_steps:g}; nearest-centroid overlap-vs-solo probe on "
        f"{len(y)} frames of speaker 1 ({y.mean():.3f} overlap): accuracy {acc:.3f} (reported, "
        f"not gated); card {smi}")
    return {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}


def _timed_steps(torch, step, n_warm: int, n_steps: int):
    """``n_warm`` calls of ``step`` (which returns a loss tensor), then the
    main path: ``n_steps`` timed calls, each synchronised, with the launches
    counted from just before to just after -> ``(times, losses, K1, K2, K3,
    K4, peak bytes)``."""
    from multimodal_av_model_tpu_torch.ops import launch_counts

    for _ in range(n_warm):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    since = launch_counts()
    times, losses = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    k1, k2, k3, k4 = launch_counts(since).values()
    return times, [x.item() for x in losses], k1, k2, k3, k4, torch.cuda.max_memory_allocated()


def _ms(times) -> str:
    """Mean, median and range of step times, in ms."""
    t = np.asarray(times) * 1e3
    return f"{t.mean():.1f} ms mean, {np.median(t):.1f} median ({t.min():.1f}-{t.max():.1f})"


def family_ref_phase(torch, tok) -> None:
    """[family-ref]: one training step of each family's small f32 model
    (dropout 0, B = 2) from one seeded state on the card (K1) and on the CPU
    (plain version), on the same batch and, for SSL, the same spans, held at
    [train-ref]'s bars; then SpecAugment's apply on the card against the
    CPU with the same draws."""
    from multimodal_av_model_tpu_torch.data.mixing import MASK_PAD
    from multimodal_av_model_tpu_torch.ops.logmel import log_mel_spectrogram_cuda
    from multimodal_av_model_tpu_torch.ops.specaugment import apply_spec_augment, draw_spec_augment
    from multimodal_av_model_tpu_torch.ops.ssl import make_span_mask
    from multimodal_av_model_tpu_torch.train.single_modality import (
        make_audio_trainer,
        make_visual_trainer,
        synthetic_audio_batches,
        synthetic_visual_batches,
    )
    from multimodal_av_model_tpu_torch.train.ssl_pretrain import MaskedAudioPretrainer

    cfg = tiny_model_config()
    cfg.model.audio.dropout = 0.0
    cfg.model.decoder.vocab_size = tok.vocab_size
    audio = next(synthetic_audio_batches(tok, 2, 1, samples=16000, label_len=8, seed=1))
    audio["inputs"][1, 9000:] = 0.0                 # a padded second row
    audio["meta"][1, 9000:] = False
    lips = next(synthetic_visual_batches(tok, 2, 1, frames=16, size=48, label_len=4, seed=2))
    lips["meta"][1] = 10
    mask1 = np.where(audio["meta"], 1, MASK_PAD).astype(np.int32)
    ssl_probe = MaskedAudioPretrainer(cfg, device="cpu")
    spans = make_span_mask(2, ssl_probe.enc_frames(16000), 0.065, 10, np.random.default_rng(3))
    del ssl_probe

    def one_step(dev, kind):
        if kind == "ssl":
            pt = MaskedAudioPretrainer(cfg, device=dev)
            state = pt.init_state(1)
            state, loss = pt.train_step(state, audio["inputs"], mask1 != MASK_PAD, spans)
        else:
            make = make_audio_trainer if kind == "audio" else make_visual_trainer
            trainer = make(cfg, tok, device=dev)
            state = trainer.init_state(1)
            state, loss = trainer.train_step(state, audio if kind == "audio" else lips)
        model = state.model
        return (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()},
                {n: b.cpu() for n, b in model.named_buffers()})

    for kind in ("audio", "visual", "ssl"):
        (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = one_step("cpu", kind), one_step("cuda", kind)
        loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        gnorm = float(torch.stack([g.norm() for g in g_cpu.values()]).norm())
        floor = 1e-3 * gnorm
        g_rel, g_name = max((float((g_gpu[n] - g).norm() / (g.norm() + floor)), n)
                            for n, g in g_cpu.items())
        s_rel, s_name = max(((float(((s_gpu[n] - b).abs() / (b.abs() + 1e-3)).max()), n)
                             for n, b in s_cpu.items()), default=(0.0, "none"))
        ok = loss_rel <= 1e-3 and g_rel <= 1e-2 and s_rel <= 1e-3 and math.isfinite(l_gpu)
        log(f"[family-ref] {kind}: small f32 model, one step, card vs CPU: loss {l_gpu:.6f} vs "
            f"{l_cpu:.6f} (rel {loss_rel:.3g}, <= 1e-3), max per-tensor gradient rel {g_rel:.3g} "
            f"at {g_name} (<= 1e-2, |dg| / (|g| + 1e-3 grad_norm)), {len(s_cpu)} BatchNorm "
            f"statistics, max rel {s_rel:.3g} at {s_name} (<= 1e-3) {'ok' if ok else 'FAILED'}")
        if not ok:
            raise SystemExit(f"family-ref: the {kind} step disagrees between card and CPU")

    x = torch.from_numpy(audio["inputs"]).cuda()
    mel = log_mel_spectrogram_cuda(x)
    anchors = np.minimum(np.arange(mel.shape[1]) * 160, x.shape[1] - 1)
    valid = torch.from_numpy(audio["meta"][:, anchors])
    draws = draw_spec_augment(torch.Generator().manual_seed(0), valid, mel.shape[2], 2, 27, 2, 0.2)
    on_card = apply_spec_augment(mel, valid.cuda(), type(draws)(
        *(t.cuda() for t in (draws.freq_width, draws.freq_start, draws.time_width,
                             draws.time_start))))
    on_cpu = apply_spec_augment(mel.cpu(), valid, draws)
    changed = int((on_cpu != mel.cpu()).sum())
    ok = torch.equal(on_card.cpu(), on_cpu) and changed > 0
    log(f"[family-ref] SpecAugment apply on K1's {tuple(mel.shape)} with one set of draws (2 "
        f"frequency stripes <= 27 bins, 2 time stripes <= 0.2 of the valid frames): card and "
        f"CPU equal ({changed} cells filled) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("family-ref: SpecAugment differs between card and CPU")


def family_audio_phase(torch, tok, smi: str) -> dict:
    """[family-audio]: the audio family at full width (12x512 Conformer, 800
    tokens, f32 as the JAX CLI builds it) on batches of ``utterance_batches``'
    static shape [8, 160000]: K1 against its plain version there, 2 warm-up
    and 10 timed ``train_step``s, then 3 with SpecAugment on."""
    from torch.utils.flop_counter import FlopCounterMode

    from multimodal_av_model_tpu_torch.config import Config
    from multimodal_av_model_tpu_torch.train.single_modality import (
        make_audio_trainer,
        synthetic_audio_batches,
    )

    cfg = Config()
    cfg.model.decoder.vocab_size = tok.vocab_size
    B, S, n_steps = 8, 160000, 10
    batch = next(synthetic_audio_batches(tok, B, 1, samples=S, label_len=40, seed=3))
    batch["valid"], batch["num_real"] = np.ones(B, np.float32), np.int32(B)
    k1_at(torch, torch.from_numpy(batch["inputs"]).cuda(), "family-audio")
    t0 = time.perf_counter()
    trainer = make_audio_trainer(cfg, tok, device="cuda")
    state = trainer.init_state(cfg.data.seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    init_s = time.perf_counter() - t0

    def step():
        return trainer.train_step(state, batch)[1]

    times, losses, k1, k2, k3, k4, peak = _timed_steps(torch, step, 2, n_steps)
    with FlopCounterMode(display=False) as counter:
        step()
        torch.cuda.synchronize()
    flops = counter.get_total_flops()
    mean = sum(times) / n_steps
    log(f"[family-audio] AudioOnlyCTC {n_params / 1e6:.1f}M params, f32 compute, init "
        f"{init_s:.1f} s; B={B} x {S} samples: {n_steps} steps in {sum(times):.3f} s: "
        f"{B * n_steps / sum(times):.2f} utt/s, {_ms(times)}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches per step K1 {k1 / n_steps:g}, K2 {k2 / n_steps:g}; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; {flops / 1e12:.3f} TFLOP per step "
        f"(FlopCounterMode), mfu {flops / mean / PEAK_BF16_FLOPS:.4f} of 989 TFLOP/s dense bf16 "
        f"({flops / mean / PEAK_F32_FLOPS:.4f} of 67 TFLOP/s f32) at the mean step; card {smi}")
    if k1 != n_steps or k2 != 0 or k4 != 0:
        raise SystemExit(f"family-audio: launches K1 {k1}, K2 {k2}, K4 {k4} over {n_steps} "
                         f"steps")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"family-audio: losses {losses}")
    a = cfg.model.audio
    a.specaug_freq_masks = a.specaug_time_masks = 2
    times2, losses2, k1b, k2b, k3b, k4b, _ = _timed_steps(torch, step, 0, 3)
    k3, k4 = k3 + k3b, k4 + k4b
    a.specaug_freq_masks = a.specaug_time_masks = 0
    log(f"[family-audio] with SpecAugment (2 frequency stripes <= {a.specaug_freq_width} bins, "
        f"2 time stripes <= {a.specaug_time_frac} of the valid frames): 3 steps, "
        f"{_ms(times2)}; losses {', '.join(f'{x:.4f}' for x in losses2)}; launches K1 {k1b}, "
        f"K2 {k2b}")
    if k1b != 3 or k2b != 0 or not all(math.isfinite(x) for x in losses2):
        raise SystemExit(f"family-audio: SpecAugment steps K1 {k1b}, K2 {k2b}, losses {losses2}")
    return {"logmel": k1 + k1b, "lip_preprocess": 0, "prefix_beam": k3, "lstm_scan": k4}


def family_visual_phase(torch, tok, smi: str) -> dict:
    """[family-visual]: the visual family at full width (ResNet-18 with
    BatchNorm and PReLU on 96x96 lips, 800 tokens, f32) on batches of
    ``utterance_batches``' static shape [8, 448, 1, 96, 96]: 2 warm-up and
    10 timed steps; no kernel runs (the lips come preprocessed from the
    host, as in JAX)."""
    from torch.utils.flop_counter import FlopCounterMode

    from multimodal_av_model_tpu_torch.config import Config
    from multimodal_av_model_tpu_torch.train.single_modality import (
        make_visual_trainer,
        synthetic_visual_batches,
    )

    cfg = Config()
    cfg.model.decoder.vocab_size = tok.vocab_size
    B, T, n_steps = 8, 448, 10
    batch = next(synthetic_visual_batches(tok, B, 1, frames=T, size=96, label_len=40, seed=4))
    batch["valid"], batch["num_real"] = np.ones(B, np.float32), np.int32(B)
    t0 = time.perf_counter()
    trainer = make_visual_trainer(cfg, tok, device="cuda")
    state = trainer.init_state(cfg.data.seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    init_s = time.perf_counter() - t0

    def step():
        return trainer.train_step(state, batch)[1]

    times, losses, k1, k2, k3, k4, peak = _timed_steps(torch, step, 2, n_steps)
    with FlopCounterMode(display=False) as counter:
        step()
        torch.cuda.synchronize()
    flops = counter.get_total_flops()
    mean = sum(times) / n_steps
    log(f"[family-visual] VisualOnlyCTC {n_params / 1e6:.1f}M params, f32 compute, BatchNorm, "
        f"init {init_s:.1f} s; B={B} x {T} frames of 96x96 ({B * T * 96 * 96 * 4 / 1e6:.0f} MB "
        f"copied from the host per step): {n_steps} steps in {sum(times):.3f} s: "
        f"{B * n_steps / sum(times):.2f} utt/s, {_ms(times)}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches per step K1 {k1 / n_steps:g}, K2 {k2 / n_steps:g}; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; {flops / 1e12:.3f} TFLOP per step, mfu "
        f"{flops / mean / PEAK_BF16_FLOPS:.4f} of 989 TFLOP/s dense bf16 "
        f"({flops / mean / PEAK_F32_FLOPS:.4f} of 67 TFLOP/s f32); card {smi}")
    if k1 != 0 or k2 != 0 or k4 != 0:
        raise SystemExit(f"family-visual: launches K1 {k1}, K2 {k2}, K4 {k4} (expected none)")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"family-visual: losses {losses}")
    return {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}


def _families_config(dirs: dict):
    from multimodal_av_model_tpu_torch.config import Config

    cfg = Config()
    for k, v in dirs.items():
        setattr(cfg.data, k, v)
    cfg.data.vocab_path = os.path.join(REPO, cfg.data.vocab_path)
    return cfg


def ssl_phase(torch, tok, dirs: dict, smi: str) -> dict:
    """[ssl]: ``MaskedAudioPretrainer`` at full width (the 12x512 Conformer
    and its head, f32) on ``build_data`` batches of the corpus with
    ``data.device_preprocess`` on (K2 x2 per batch), B = 8: K1 and K2
    against their plain versions at the step's shapes, then 2 warm-up and
    10 timed steps, each with its batch's fetch and its spans."""
    from multimodal_av_model_tpu_torch import main as cli
    from multimodal_av_model_tpu_torch.data.collate import collate_pairs_raw, make_bucket_specs
    from multimodal_av_model_tpu_torch.data.manifest import build_data_list, train_val_test_split
    from multimodal_av_model_tpu_torch.data.mixing import MASK_PAD
    from multimodal_av_model_tpu_torch.data.pairs import RandomPairSampler
    from multimodal_av_model_tpu_torch.data.pipeline import FilePairSource, bucketed_batches
    from multimodal_av_model_tpu_torch.ops.ssl import make_span_mask
    from multimodal_av_model_tpu_torch.train.ssl_pretrain import MaskedAudioPretrainer

    cfg = _families_config(dirs)
    B, n_steps = 8, 10
    cfg.train.batch_size, cfg.data.num_pairs_per_epoch = B, B * (n_steps + 2)
    specs = make_bucket_specs(cfg.data.video_buckets, cfg.data.audio_samples_per_video_frame,
                              cfg.data.max_label_len)
    entries, _ = build_data_list(dirs["json_folder"], dirs["npy_dir"], dirs["text_dir"],
                                 dirs["wav_dir"])
    train_set, _, _ = train_val_test_split(entries, seed=cfg.data.seed)
    sampler = RandomPairSampler(train_set, FilePairSource(tok).load_pair_raw, B, seed=7)
    raw = next(iter(bucketed_batches(iter(sampler), specs, B, collate_fn=collate_pairs_raw)))
    train_kernel_check(torch, B, raw, "ssl")
    del raw

    train_factory, _ = cli.build_data(cfg, tok, False, "cuda", device_put=False)
    t0 = time.perf_counter()
    ssl = MaskedAudioPretrainer(cfg, mask_prob=cfg.train.ssl_mask_prob,
                                span=cfg.train.ssl_mask_span,
                                temperature=cfg.train.ssl_temperature, device="cuda")
    state = ssl.init_state(cfg.data.seed)
    n_params = sum(p.numel() for p in state.model.parameters())
    init_s = time.perf_counter() - t0
    batches = iter(train_factory())
    span_rng = np.random.default_rng(cfg.data.seed * 1009 + 1)
    shapes = set()
    # A probe: the InfoNCE of one held batch and spans, without dropout,
    # before and after the steps (the steps' own losses move with their
    # batches).
    held = next(train_factory())
    held_spans = torch.from_numpy(make_span_mask(
        held["audio"].shape[0], ssl.enc_frames(held["audio"].shape[1]), ssl.mask_prob,
        ssl.span, np.random.default_rng(11))).cuda()

    def probe():
        from multimodal_av_model_tpu_torch.ops.ssl import masked_infonce_loss

        with torch.no_grad():
            preds, targets, fv = state.model(held["audio"], held["mask1"] != MASK_PAD, held_spans)
            return masked_infonce_loss(preds, targets, held_spans, fv, ssl.temperature).item()

    before = probe()

    def step():
        nonlocal state
        batch = next(batches)
        shapes.add(tuple(batch["audio"].shape))
        spans = make_span_mask(batch["audio"].shape[0], ssl.enc_frames(batch["audio"].shape[1]),
                               ssl.mask_prob, ssl.span, span_rng)
        state, loss = ssl.train_step(state, batch["audio"], batch["mask1"] != MASK_PAD, spans)
        return loss

    times, losses, k1, k2, k3, k4, peak = _timed_steps(torch, step, 2, n_steps)
    batches.close()
    after = probe()
    log(f"[ssl] MaskedAudioPretrainer {n_params / 1e6:.1f}M params, f32, init {init_s:.1f} s; "
        f"B={B} mixtures {sorted(shapes)} from build_data (device_preprocess): {n_steps} steps "
        f"(each with its batch's fetch, K2 and spans) in {sum(times):.3f} s: "
        f"{B * n_steps / sum(times):.2f} utt/s, {_ms(times)}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches per step K1 {k1 / n_steps:g}, K2 {k2 / n_steps:g}; "
        f"InfoNCE of the steps {', '.join(f'{x:.4f}' for x in losses)}; of one held batch "
        f"without dropout {before:.4f} before the {n_steps + 2} steps, {after:.4f} after; "
        f"card {smi}")
    if k1 != n_steps or k2 != 2 * n_steps or k4 != 0:
        raise SystemExit(f"ssl: launches K1 {k1}, K2 {k2}, K4 {k4} over {n_steps} steps")
    if not all(math.isfinite(x) for x in losses) or not after < before:
        raise SystemExit(f"ssl: InfoNCE {losses}, held batch {before} -> {after}")
    return {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}


def families_cli_phase(torch, tok, dirs: dict, root: str, smi: str) -> dict:
    """[families-cli]: the port's CLI at full width on the corpus: the audio
    family for 2 epochs and a resume to 3, its ``--eval``, ``--infer`` and
    ``--stream`` of one source WAV, the visual family for 1 epoch, the SSL
    family for 1 epoch, then one flagship epoch with both encoders grafted.
    Each call's seconds, peak memory and launches: K1 once per audio-encoder
    forward, K2 twice per forward on the flagship's and SSL's batches,
    neither in the visual family; K4 only in the flagship's, twice per
    forward and twice per training step's backward."""
    import contextlib

    from multimodal_av_model_tpu_torch import main as cli
    from multimodal_av_model_tpu_torch.data.manifest import build_data_list, train_val_test_split
    from multimodal_av_model_tpu_torch.models.audio import AudioEncoder
    from multimodal_av_model_tpu_torch.ops import launch_counts
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer

    cfg = _families_config(dirs)
    entries, _ = build_data_list(dirs["json_folder"], dirs["npy_dir"], dirs["text_dir"],
                                 dirs["wav_dir"])
    train_set, val_set, _ = train_val_test_split(entries, seed=cfg.data.seed)
    common = ([f"data.{k}={v}" for k, v in dirs.items()]
              + [f"data.vocab_path={cfg.data.vocab_path}", "train.batch_size=8",
                 "train.eval_batch_size=4", "data.num_pairs_per_epoch=32", "data.eval_pairs=8",
                 "--device=cuda"])
    ck = {name: os.path.join(root, name) for name in ("audio", "visual", "ssl", "av")}
    forwards, steps = [0], [0]
    original, original_step = AudioEncoder.forward, MultiSpeakerTrainer.train_step

    def counted(self, *args, **kwargs):
        forwards[0] += 1
        return original(self, *args, **kwargs)

    def counted_step(self, *args, **kwargs):
        steps[0] += 1
        return original_step(self, *args, **kwargs)

    def run(tag, args, k2_per_forward):
        forwards[0] = steps[0] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        since = launch_counts()
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            cli.main(common + args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k1, k2, k3, k4 = launch_counts(since).values()
        n = forwards[0]
        k4_want = 2 * (n + steps[0]) if "grafted" in tag else 0
        log(f"[families-cli] {tag}: {dt:.1f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {n} audio-encoder forwards, "
            f"{steps[0]} flagship training steps; launches K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4}")
        if (k1 != n or k2 != k2_per_forward * n or (n == 0) != ("--family=visual" in args)
                or k4 != k4_want):
            raise SystemExit(f"families-cli: {tag}: launches K1 {k1}, K2 {k2}, K4 {k4} over {n} "
                             f"forwards (expected 1, {k2_per_forward} and, with "
                             f"{steps[0]} steps, {k4_want})")
        return "".join(tee.text), k1, k2, k3, k4

    def epochs(tag, text):
        for line in text.splitlines():
            if line.startswith("[epoch "):
                kv = dict(f.split("=", 1) for f in line.split()[2:])
                if not (math.isfinite(float(kv["train_loss"]))
                        and math.isfinite(float(kv["eval_loss"]))):
                    raise SystemExit(f"families-cli: {tag}: {line}")
                log(f"[families-cli] {tag}, {line}")

    AudioEncoder.forward, MultiSpeakerTrainer.train_step = counted, counted_step
    launches = {"logmel": 0, "lip_preprocess": 0, "prefix_beam": 0, "lstm_scan": 0}
    wav = os.path.join(dirs["wav_dir"], sorted(os.listdir(dirs["wav_dir"]))[0])
    try:
        for tag, args, k2 in (
                ("--family=audio, 2 epochs", ["--family=audio", f"train.checkpoint_dir={ck['audio']}",
                                              "train.max_epochs=2"], 0),
                ("--family=audio, resume to epoch 3",
                 ["--family=audio", f"train.checkpoint_dir={ck['audio']}", "train.max_epochs=3"], 0),
                ("--eval --family=audio",
                 ["--family=audio", "--eval", f"train.checkpoint_dir={ck['audio']}"], 0),
                ("--infer --family=audio",
                 ["--family=audio", "--infer", f"train.checkpoint_dir={ck['audio']}"], 0),
                ("--stream of a source WAV on the audio family's checkpoint",
                 [f"--stream={wav}", f"train.checkpoint_dir={ck['audio']}"], 0),
                ("--family=visual, 1 epoch",
                 ["--family=visual", f"train.checkpoint_dir={ck['visual']}", "train.max_epochs=1"],
                 0),
                ("--family=ssl, 1 epoch",
                 ["--family=ssl", f"train.checkpoint_dir={ck['ssl']}", "train.max_epochs=1"], 2),
                ("flagship, 1 epoch with both encoders grafted",
                 [f"train.checkpoint_dir={ck['av']}", "train.max_epochs=1",
                  f"train.audio_init_ckpt={os.path.join(ck['ssl'], 'last.ckpt')}",
                  f"train.visual_init_ckpt={os.path.join(ck['visual'], 'last.ckpt')}"], 2)):
            text, k1, k2n, k3, k4 = run(tag, args, k2)
            launches = add_launches(launches, (k1, k2n, k3, k4))
            epochs(tag, text)
            lines = text.splitlines()
            if tag.endswith("2 epochs") and "[epoch 2]" not in text:
                raise SystemExit("families-cli: the audio family did not train 2 epochs")
            if "resume" in tag and (f"at epoch 3" not in text or "[epoch 3]" not in text):
                raise SystemExit("families-cli: the audio family did not resume at epoch 3")
            if tag.startswith("--eval"):
                report = json.loads(lines[-1])
                if report["family"] != "audio" or set(report["decode"]) != {"greedy",
                                                                              "prefix_beam"}:
                    raise SystemExit(f"families-cli: --eval report {report}")
                log(f"[families-cli] --eval report: {lines[-1]}")
            if tag.startswith("--infer"):
                utts = [ln for ln in lines if ln.startswith("[utt ")]
                if len(utts) != len(val_set) or lines[-1] != f"transcribed {len(val_set)} utterances":
                    raise SystemExit(f"families-cli: --infer printed {len(utts)} utterances")
            if tag.startswith("--stream") and not lines[0].startswith(f"streaming {wav} ("):
                raise SystemExit(f"families-cli: --stream printed {lines[:2]}")
            if "ssl" in tag:
                loss = [ln for ln in lines if ln.startswith("[ssl epoch 1] infonce=")]
                if not loss or not math.isfinite(float(loss[0].split("=")[1])):
                    raise SystemExit(f"families-cli: --family=ssl printed {lines[-3:]}")
                log(f"[families-cli] {loss[0]}")
            if "grafted" in tag:
                for part in ("audio", "visual"):
                    if f"grafted {part} encoder from " not in text:
                        raise SystemExit(f"families-cli: no {part} graft line")
                log("[families-cli] " + "; ".join(ln for ln in lines if ln.startswith("grafted")))
    finally:
        AudioEncoder.forward, MultiSpeakerTrainer.train_step = original, original_step
    log(f"[families-cli] {len(train_set)} train and {len(val_set)} val utterances; launches "
        f"over the phase K1 {launches['logmel']}, K2 {launches['lip_preprocess']}, K3 "
        f"{launches['prefix_beam']}, K4 {launches['lstm_scan']}; card {smi}")
    return launches


def families_phase(torch, tok, smi: str) -> dict:
    """[ssl] and [families-cli] on one corpus written for them (as [fit]'s:
    8 speakers x 6 sentences of 3.0-4.2 s) -> each path's launches."""
    import shutil
    import tempfile

    from multimodal_av_model_tpu_torch.data.synth_corpus import write_synthetic_corpus

    root = tempfile.mkdtemp(prefix="mmav_families_")
    try:
        dirs = write_synthetic_corpus(os.path.join(root, "corpus"), tok, n_videos=8,
                                      sentences_per_video=6, sentence_dur=(3.0, 4.2), seed=0)
        return {"ssl": ssl_phase(torch, tok, dirs, smi),
                "families_cli": families_cli_phase(torch, tok, dirs, root, smi)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _legacy_batch(samples):
    """Legacy samples -> one batch: frames zero-padded to the longest clip,
    mel zero-padded to the longest (``mel_lengths`` keep each length, which
    only CTC reads, as in JAX), labels padded with the blank."""
    T = max(s[k].shape[0] for s in samples for k in ("frames_A", "frames_B"))
    M = max(s["mel"].shape[0] for s in samples)
    L = max(max(len(s["label_A"]), len(s["label_B"])) for s in samples)

    def pad(a, n):
        return np.concatenate([a, np.zeros((n - a.shape[0], *a.shape[1:]), a.dtype)])
    return {"frames_A": np.stack([pad(s["frames_A"], T) for s in samples]).astype(np.float32),
            "frames_B": np.stack([pad(s["frames_B"], T) for s in samples]).astype(np.float32),
            "mel": np.stack([pad(s["mel"], M) for s in samples]),
            "mel_lengths": np.array([s["mel"].shape[0] for s in samples], np.int32),
            "label_A": np.stack([pad(s["label_A"], L) for s in samples]),
            "len_A": np.array([len(s["label_A"]) for s in samples], np.int32),
            "label_B": np.stack([pad(s["label_B"], L) for s in samples]),
            "len_B": np.array([len(s["label_B"]) for s in samples], np.int32)}


def legacy_ref_phase(torch) -> None:
    """[legacy-ref]: one step of a small f32 legacy model (hidden 16, 24x32
    frames, 40 ids, B = 2, T_lip 6 and T_mel 40) from one seeded state on
    the card and on the CPU, held at [family-ref]'s bars."""
    from multimodal_av_model_tpu_torch.train.legacy import LegacyTrainer

    rng = np.random.default_rng(12)
    samples = [{"frames_A": rng.uniform(size=(6, 24, 32, 3)).astype(np.float32),
                "frames_B": rng.uniform(size=(6, 24, 32, 3)).astype(np.float32),
                "mel": rng.standard_normal((n, 80)).astype(np.float32),
                "label_A": rng.integers(1, 40, size=4).astype(np.int32),
                "label_B": rng.integers(1, 40, size=3).astype(np.int32)} for n in (40, 31)]
    batch = _legacy_batch(samples)

    def one_step(dev):
        trainer = LegacyTrainer(40, 16, image_size=(24, 32), device=dev)
        state, loss = trainer.train_step(trainer.init_state(1), batch)
        return loss.item(), {n: p.grad.cpu() for n, p in state.model.named_parameters()}

    (l_cpu, g_cpu), (l_gpu, g_gpu) = one_step("cpu"), one_step("cuda")
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    floor = 1e-3 * float(torch.stack([g.norm() for g in g_cpu.values()]).norm())
    g_rel, g_name = max((float((g_gpu[n] - g).norm() / (g.norm() + floor)), n)
                        for n, g in g_cpu.items())
    ok = loss_rel <= 1e-3 and g_rel <= 1e-2 and math.isfinite(l_gpu)
    log(f"[legacy-ref] small f32 legacy model, one step, card vs CPU: loss {l_gpu:.6f} vs "
        f"{l_cpu:.6f} (rel {loss_rel:.3g}, <= 1e-3), max per-tensor gradient rel {g_rel:.3g} at "
        f"{g_name} (<= 1e-2, |dg| / (|g| + 1e-3 grad_norm)) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit("legacy-ref: the legacy step disagrees between card and CPU")


def legacy_phase(torch, tok, smi: str) -> dict:
    """[legacy]: on a corpus written as [fit]'s, ``build_all_pair_samples``
    (16 pairs), K1 against its plain version at each mixture's [1, S], then
    the main path: ``load_legacy_sample`` on the card for every sample (K1
    once each, K2 never) and ``LegacyTrainer.fit`` at full width (hidden 256,
    96x96, 11,173 ids, B = 4, 3 epochs), each step timed.  The loss of one
    held batch must fall."""
    import shutil
    import tempfile

    from multimodal_av_model_tpu_torch.data.audio_io import load_audio
    from multimodal_av_model_tpu_torch.data.legacy_preprocess import build_all_pair_samples
    from multimodal_av_model_tpu_torch.data.manifest import build_data_list
    from multimodal_av_model_tpu_torch.data.synth_corpus import write_synthetic_corpus
    from multimodal_av_model_tpu_torch.ops import launch_counts, logmel
    from multimodal_av_model_tpu_torch.ops.logmel import log_mel_spectrogram_cuda
    from multimodal_av_model_tpu_torch.text import KoreanSyllableVocab
    from multimodal_av_model_tpu_torch.train.legacy import (
        LegacyTrainer,
        load_legacy_sample,
        scan_legacy_root,
    )

    root = tempfile.mkdtemp(prefix="mmav_legacy_")
    try:
        t0 = time.perf_counter()
        dirs = write_synthetic_corpus(os.path.join(root, "corpus"), tok, n_videos=8,
                                      sentences_per_video=6, sentence_dur=(3.0, 4.2), seed=0)
        entries, _ = build_data_list(dirs["json_folder"], dirs["npy_dir"], dirs["text_dir"],
                                     dirs["wav_dir"])
        built = build_all_pair_samples(entries, os.path.join(root, "legacy"), max_pairs=16)
        sample_dirs = scan_legacy_root(os.path.join(root, "legacy"))
        if sample_dirs != built or len(built) != 16:
            raise SystemExit(f"legacy: {len(built)} sample directories built, "
                             f"{len(sample_dirs)} found")
        log(f"[legacy] corpus of {len(entries)} sentences -> {len(built)} sample directories in "
            f"{time.perf_counter() - t0:.1f} s")

        waves = [torch.from_numpy(load_audio(os.path.join(d, "mixed.wav")))[None].cuda()
                 for d in sample_dirs]
        k1_err, longest = 0.0, max(waves, key=lambda w: w.shape[1])
        for w in waves:                              # K1 at each mixture's [1, S]
            got, ref = log_mel_spectrogram_cuda(w), logmel.log_mel_spectrogram(w)
            k1_err = max(k1_err, (got - ref).abs().max().item())
            if not torch.allclose(got, ref, rtol=2e-3, atol=2e-3):
                raise SystemExit(f"legacy: K1 disagrees with its plain version at "
                                 f"{tuple(w.shape)}: {k1_err}")
        k1_ms = cuda_ms(log_mel_spectrogram_cuda, [(longest,)], 100, graph=True)
        T1 = logmel.num_frames(longest.shape[1])
        b_ms, b_by = bound(0.0, longest.numel() * 4 + T1 * 80 * 4)
        log(f"[legacy] K1 at the {len(waves)} mixtures' [1, S] (S {min(w.shape[1] for w in waves)}"
            f"-{longest.shape[1]}): max|kernel-plain| {k1_err:.3g} (rtol=atol=2e-3) ok; at "
            f"{tuple(longest.shape)} {k1_ms:.4f} ms by graph replay, bound {b_ms:.4f} ms by "
            f"{b_by} ({b_ms / k1_ms:.3f} of it)")
        del waves, longest

        vocab = KoreanSyllableVocab()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        since = launch_counts()
        t0 = time.perf_counter()
        samples = [load_legacy_sample(d, vocab, device="cuda") for d in sample_dirs]
        load_s = time.perf_counter() - t0
        k1_load, k2_load, _, _ = launch_counts(since).values()
        shapes = sorted({(max(s["frames_A"].shape[0], s["frames_B"].shape[0]), s["mel"].shape[0])
                         for s in samples})
        if k1_load != len(samples) or k2_load != 0:
            raise SystemExit(f"legacy: loading {len(samples)} samples launched K1 {k1_load}, "
                             f"K2 {k2_load}")
        if any(len(s["label_A"]) == 0 or len(s["label_B"]) == 0 for s in samples):
            raise SystemExit("legacy: a sample has an empty syllable label")
        log(f"[legacy] load_legacy_sample x {len(samples)} on the card: {load_s:.2f} s "
            f"({len(samples) / load_s:.1f} samples/s), K1 {k1_load} (one per sample), K2 0; "
            f"(T_lip, T_mel) {shapes[0]}-{shapes[-1]}, frames {samples[0]['frames_A'].shape[1:]}")

        B, epochs = 4, 3
        batches = [_legacy_batch(samples[i:i + B]) for i in range(0, len(samples), B)]
        del samples
        t0 = time.perf_counter()
        trainer = LegacyTrainer(vocab.vocab_size, 256, device="cuda")
        state = trainer.init_state(0)
        n_params = sum(p.numel() for p in state.model.parameters())
        init_s = time.perf_counter() - t0
        held = batches[0]

        def held_loss():
            with torch.no_grad():
                return trainer.loss_fn(state.model, place(held)).item()

        def place(batch):
            return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}

        before = held_loss()
        times, losses = [], []
        step = trainer.train_step

        def timed_step(st, batch):
            t1 = time.perf_counter()
            st, loss = step(st, batch)
            losses.append(loss.item())
            times.append(time.perf_counter() - t1)
            return st, loss

        trainer.train_step = timed_step
        lines = []
        state = trainer.fit(state, batches, epochs=epochs, log_fn=lines.append)
        del trainer.train_step
        after = held_loss()
        k1, k2, k3, k4 = launch_counts(since).values()
        peak = torch.cuda.max_memory_allocated()
        for line in lines:
            log(f"[legacy] fit: {line}")
        n = len(times)
        log(f"[legacy] LegacyTrainer {n_params / 1e6:.1f}M params (hidden "
            f"{trainer.hidden_dim}, 96x96x3, {vocab.vocab_size} ids), f32, init {init_s:.1f} s; B={B} x {len(batches)} batches x "
            f"{epochs} epochs: {n} steps in {sum(times):.3f} s: {B * n / sum(times):.2f} utt/s, "
            f"{_ms(times)} (the first step included); peak device memory "
            f"{peak / 2**30:.2f} GiB; held batch loss {before:.4f} -> {after:.4f}; launches over "
            f"the path K1 {k1} (the {k1_load} loads), K2 {k2}; card {smi}")
        if k1 != k1_load or k2 != 0 or k4 != 0 or n != epochs * len(batches):
            raise SystemExit(f"legacy: launches K1 {k1}, K2 {k2}, K4 {k4}, {n} steps")
        if not all(math.isfinite(x) for x in losses) or not after < before:
            raise SystemExit(f"legacy: losses {losses}, held batch {before} -> {after}")
        if len(lines) != epochs or not all(ln.startswith(f"[Epoch {i + 1}] Loss: ")
                                           for i, ln in enumerate(lines)):
            raise SystemExit(f"legacy: fit printed {lines}")
        return {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _reference_checkpoint(torch, template: dict, seed: int) -> dict:
    """A full reference save (``{'epoch', 'visual_encoder', 'audio_encoder',
    'fusion', 'decoder1', 'optimizer'}``, the upstream layout) whose tensors
    fit the flagship state dict ``template``, drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)

    def rand(*s, lo=-0.05, hi=0.05):
        return torch.rand(*s, generator=g) * (hi - lo) + lo

    def bn(out, src, n):
        out[f"{src}.weight"] = rand(n, lo=0.5, hi=1.5)
        out[f"{src}.bias"] = rand(n)
        out[f"{src}.running_mean"] = rand(n, lo=-0.2, hi=0.2)
        out[f"{src}.running_var"] = rand(n, lo=0.5, hi=1.5)
        out[f"{src}.num_batches_tracked"] = torch.tensor(1000)

    shape = lambda k: tuple(template[k].shape)  # noqa: E731
    vis: dict = {}
    c0, kt, kh, kw = shape("visual_encoder.frontend_conv.weight")
    vis["frontend3D.0.weight"] = rand(c0, 1, kt, kh, kw)
    bn(vis, "frontend3D.1", c0)
    vis["frontend3D.2.weight"] = rand(c0, lo=0.05, hi=0.5)
    n_blocks = len({k.split(".")[3] for k in template if k.startswith("visual_encoder.trunk.")})
    per_stage = n_blocks // 4                        # ResNet-18: 2 blocks in each of 4 stages
    for i in range(n_blocks):
        pre, port = f"trunk.layer{i // per_stage + 1}.{i % per_stage}", \
            f"visual_encoder.trunk.blocks.{i}"
        vis[f"{pre}.conv1.weight"] = rand(*shape(f"{port}.conv1.weight"))
        bn(vis, f"{pre}.bn1", shape(f"{port}.norm1.weight")[0])
        vis[f"{pre}.conv2.weight"] = rand(*shape(f"{port}.conv2.weight"))
        bn(vis, f"{pre}.bn2", shape(f"{port}.norm2.weight")[0])
        if f"{port}.downsample.0.weight" in template:
            vis[f"{pre}.downsample.0.weight"] = rand(*shape(f"{port}.downsample.0.weight"))
            bn(vis, f"{pre}.downsample.1", shape(f"{port}.downsample.1.weight")[0])
        vis[f"{pre}.relu.weight"] = rand(shape(f"{port}.act1.alpha")[0], lo=0.05, hi=0.5)
    fus: dict = {}
    for name in ("visual_proj", "audio_proj", "fusion_proj"):
        fus[f"{name}.weight"] = rand(*shape(f"fusion.{name}.weight"))
        fus[f"{name}.bias"] = rand(*shape(f"fusion.{name}.bias"))
    E = shape("fusion.cross_attn_audio.query.weight")[0]
    for name in ("cross_attn_audio", "cross_attn_visual"):
        fus[f"{name}.in_proj_weight"] = rand(3 * E, E)
        fus[f"{name}.in_proj_bias"] = rand(3 * E)
        fus[f"{name}.out_proj.weight"] = rand(E, E)
        fus[f"{name}.out_proj.bias"] = rand(E)
    layers = len({k for k in template if k.startswith("fusion.temporal_bilstm.layers.")}) // 3
    for layer in range(layers):
        _, H4, d_in = shape(f"fusion.temporal_bilstm.layers.{layer}.w_ih")
        for suffix in ("", "_reverse"):
            fus[f"temporal_model.weight_ih_l{layer}{suffix}"] = rand(H4, d_in)
            fus[f"temporal_model.weight_hh_l{layer}{suffix}"] = rand(H4, H4 // 4)
            fus[f"temporal_model.bias_ih_l{layer}{suffix}"] = rand(H4)
            fus[f"temporal_model.bias_hh_l{layer}{suffix}"] = rand(H4)
    V, D = shape("decoder.head.weight")
    return {"epoch": 12, "visual_encoder": vis, "audio_encoder": {"w2v.weight": rand(4, 4)},
            "fusion": fus, "decoder1": {"net.0.weight": rand(V, D), "net.0.bias": rand(V)},
            "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4, "params": [0]}]}}


def _mapped(torch, ckpt: dict) -> dict:
    """What each reference tensor must become in the port's state dict, the
    mapping stated once more here, independent of ``compat/torch_import``."""
    out = {}
    vis, fus = ckpt["visual_encoder"], ckpt["fusion"]
    out["visual_encoder.frontend_conv.weight"] = vis["frontend3D.0.weight"].squeeze(1)
    out["visual_encoder.frontend_act.alpha"] = vis["frontend3D.2.weight"]
    stats = ("weight", "bias", "running_mean", "running_var")
    for k in stats:
        out[f"visual_encoder.frontend_norm.{k}"] = vis[f"frontend3D.1.{k}"]
    blocks = sorted({(int(k.split(".")[1][5:]), int(k.split(".")[2]))
                     for k in vis if k.startswith("trunk.")})
    for i, (s, b) in enumerate(blocks):
        src, dst = f"trunk.layer{s}.{b}", f"visual_encoder.trunk.blocks.{i}"
        for a, c in (("conv1", "conv1"), ("conv2", "conv2"), ("downsample.0", "downsample.0")):
            if f"{src}.{a}.weight" in vis:
                out[f"{dst}.{c}.weight"] = vis[f"{src}.{a}.weight"]
        for a, c in (("bn1", "norm1"), ("bn2", "norm2"), ("downsample.1", "downsample.1")):
            for k in stats:
                if f"{src}.{a}.{k}" in vis:
                    out[f"{dst}.{c}.{k}"] = vis[f"{src}.{a}.{k}"]
        out[f"{dst}.act1.alpha"] = out[f"{dst}.act2.alpha"] = vis[f"{src}.relu.weight"]
    for name in ("visual_proj", "audio_proj", "fusion_proj"):
        for k in ("weight", "bias"):
            out[f"fusion.{name}.{k}"] = fus[f"{name}.{k}"]
    q, kk, v = fus["cross_attn_audio.in_proj_weight"].chunk(3)
    qb, kb, vb = fus["cross_attn_audio.in_proj_bias"].chunk(3)
    for name, w, b in (("query", q, qb), ("key", kk, kb), ("value", v, vb)):
        out[f"fusion.cross_attn_audio.{name}.weight"] = w
        out[f"fusion.cross_attn_audio.{name}.bias"] = b
    out["fusion.cross_attn_audio.out.weight"] = fus["cross_attn_audio.out_proj.weight"]
    out["fusion.cross_attn_audio.out.bias"] = fus["cross_attn_audio.out_proj.bias"]
    layer = 0
    while f"temporal_model.weight_ih_l{layer}" in fus:
        d = f"fusion.temporal_bilstm.layers.{layer}"
        for j, sfx in enumerate(("", "_reverse")):
            out[f"{d}.w_ih[{j}]"] = fus[f"temporal_model.weight_ih_l{layer}{sfx}"]
            out[f"{d}.w_hh[{j}]"] = fus[f"temporal_model.weight_hh_l{layer}{sfx}"]
            out[f"{d}.b_hh[{j}]"] = (fus[f"temporal_model.bias_ih_l{layer}{sfx}"]
                                     + fus[f"temporal_model.bias_hh_l{layer}{sfx}"])
        layer += 1
    out["decoder.head.weight"] = ckpt["decoder1"]["net.0.weight"]
    out["decoder.head.bias"] = ckpt["decoder1"]["net.0.bias"]
    return out


def reference_import_phase(torch, rng, tok, smi: str):
    """[reference-import]: a full-width reference-layout checkpoint with
    seeded tensors, imported through the port's CLI (``python -m
    multimodal_av_model_tpu_torch.compat.torch_import``, file work on the
    host); every mapped tensor held equal to its source under the mapping;
    then three bucket-128 requests served from the imported file by
    ``Transcriber.from_checkpoint`` on the card (K1 1 and K2 2 each).
    Returns the launches and the Transcriber."""
    import shutil
    import tempfile

    from multimodal_av_model_tpu_torch.config import Config
    from multimodal_av_model_tpu_torch.data.collate import make_bucket_specs
    from multimodal_av_model_tpu_torch.infer import Transcriber
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel, init_weights
    from multimodal_av_model_tpu_torch.ops import launch_counts
    from multimodal_av_model_tpu_torch.train.checkpoints import restore_checkpoint

    cfg = Config()
    root = tempfile.mkdtemp(prefix="mmav_reference_")
    try:
        with torch.device("meta"):
            shapes = MultiSpeakerAVModel(cfg.model).state_dict()
        ckpt = _reference_checkpoint(torch, shapes, seed=21)
        src, out = os.path.join(root, "reference.pt"), os.path.join(root, "imported.ckpt")
        torch.save(ckpt, src)
        n_ref = sum(v.numel() for part in ("visual_encoder", "fusion", "decoder1")
                    for v in ckpt[part].values())
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m",
                              "multimodal_av_model_tpu_torch.compat.torch_import", src, out,
                              str(cfg.model.decoder.vocab_size)],
                             cwd=REPO, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise SystemExit(f"reference-import: the CLI failed:\n{run.stdout}\n{run.stderr}")
        printed = run.stdout.strip().splitlines()
        if printed[0] != f"imported: ['visual_encoder', 'fusion', 'decoder'] -> {out}" or \
                [ln.split(" (")[0] for ln in printed[1:]] != ["skipped: audio_encoder",
                                                             "skipped: optimizer"]:
            raise SystemExit(f"reference-import: the CLI printed {printed}")
        saved = restore_checkpoint(out)
        sd = saved["state"]["model"]
        want = _mapped(torch, ckpt)
        for key, value in want.items():
            name, _, idx = key.partition("[")
            got = sd[name][int(idx[:-1])] if idx else sd[name]
            if not torch.equal(got, value.float()):
                raise SystemExit(f"reference-import: {key} differs from its source")
        template = init_weights(MultiSpeakerAVModel(cfg.model),
                                torch.Generator().manual_seed(0)).state_dict()
        kept = [k for k in sd if k.startswith(("audio_encoder.", "contrastive_proj."))]
        if any(not torch.equal(sd[k], template[k]) for k in kept) or saved["epoch"] != 12:
            raise SystemExit("reference-import: the entries the checkpoint lacks changed")
        mapped = {k.partition("[")[0] for k in want}
        if mapped | set(kept) != set(sd):
            raise SystemExit(f"reference-import: unmapped keys {sorted(set(sd) - mapped)[:5]}")
        log(f"[reference-import] a full-width reference checkpoint ({n_ref / 1e6:.1f}M values in "
            f"visual_encoder, fusion, decoder1; {os.path.getsize(src) / 2**20:.0f} MB) through "
            f"the CLI in {cli_s:.1f} s; {len(want)} mapped tensors equal to their sources, "
            f"{len(kept)} audio-encoder and contrastive tensors kept from the template; printed "
            f"{printed[0].split(' -> ')[0]}; {'; '.join(p.split(' (')[0] for p in printed[1:])}")
        del ckpt, saved, sd, template, want

        t0 = time.perf_counter()
        transcriber = Transcriber.from_checkpoint(cfg, tok, out, device="cuda")
        load_s = time.perf_counter() - t0
        spec = make_bucket_specs((128,), cfg.data.audio_samples_per_video_frame,
                                 cfg.data.max_label_len)[0]
        requests = [make_request(rng, 4, spec) for _ in range(4)]
        transcriber.transcribe(_flagship_batch(torch, requests[0]))     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        since = launch_counts()
        lat, per_request = [], []
        for raw in requests[1:]:                    # the main path
            before = launch_counts()
            t0 = time.perf_counter()
            texts = transcriber.transcribe(_flagship_batch(torch, raw))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            per_request.append(tuple(launch_counts(before).values())[:2])
            if len(texts) != 4 or not all(isinstance(x, str) for p in texts for x in p):
                raise SystemExit("reference-import: expected one text per speaker")
        k1, k2, k3, k4 = launch_counts(since).values()
        log(f"[reference-import] Transcriber.from_checkpoint of the imported file "
            f"({cfg.model.dtype}) {load_s:.1f} s; 3 requests B=4 bucket 128: "
            f"{', '.join(f'{x * 1e3:.1f}' for x in lat)} ms; launches per request "
            f"{per_request}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; card {smi}")
        if per_request != [(1, 2)] * 3 or k4 != 2 * 3:
            raise SystemExit(f"reference-import: launches per request {per_request}, K4 {k4} "
                             f"(expected 2 a request)")
        return {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}, transcriber
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _face_video(rng, T: int, H: int, W: int, speaker: int):
    """A talking head: a skin ellipse on grey, a red lip ellipse whose centre
    drifts and whose height opens and closes, and noise -> uint8 ``[T, H, W,
    3]`` frames and each frame's tight lip box."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = np.empty((T, H, W, 3), np.uint8)
    boxes = np.zeros((T, 4), np.int32)
    face = ((xx - W / 2) / (0.32 * W)) ** 2 + ((yy - 0.45 * H) / (0.42 * H)) ** 2 <= 1.0
    for t in range(T):
        cx = W * (0.5 + 0.08 * np.sin(0.07 * t + speaker))
        cy = H * (0.62 + 0.03 * np.cos(0.05 * t))
        ax, ay = 0.11 * W, 0.04 * H * (1.0 + 0.5 * (1 + np.sin(0.4 * t)) / 2)
        img = np.empty((H, W, 3), np.float32)
        img[...] = (95, 100, 110)
        img[face] = (205, 165, 145)
        lips = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0
        img[lips] = (185, 70, 80)
        img += rng.normal(0, 3.0, img.shape).astype(np.float32)
        frames[t] = np.clip(img, 0, 255).astype(np.uint8)
        ys, xs = np.nonzero(lips)
        boxes[t] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
    return frames, boxes


def lip_extract_phase(torch, rng, tok, transcriber, smi: str) -> dict:
    """[lip-extract]: two AVIs written by ``write_avi`` (a moving red lip on
    a face, 6 s of 320x240 at 30 fps) with an AI-Hub JSON of 3 sentences
    each; ``extract_clips`` through ``open_video`` and the default localizer
    (the heuristic, since mediapipe does not import), its boxes held to the
    drawn lips; K2 against its plain version at the clips' [T, 128, 128, 3];
    then 3 requests, each the two speakers' clips of one sentence and a
    mixture, served by ``transcriber`` (K1 1 and K2 2 each)."""
    import shutil
    import tempfile

    from multimodal_av_model_tpu_torch.data.avi import open_video, write_avi
    from multimodal_av_model_tpu_torch.data.collate import (
        collate_pairs_raw,
        make_bucket_specs,
        pick_bucket,
    )
    from multimodal_av_model_tpu_torch.data.lip_extract import (
        detect_lip_boxes_auto,
        extract_clips,
        have_mediapipe,
    )
    from multimodal_av_model_tpu_torch.ops import launch_counts, resize

    root = tempfile.mkdtemp(prefix="mmav_lip_extract_")
    try:
        T, H, W, fps, margin = 180, 240, 320, 30, 10
        spans = [(0.2, 1.9), (2.1, 3.9), (4.1, 5.8)]
        clips, n_frames, extract_s, truth = {}, 0, 0.0, {}
        for v in (1, 2):
            frames, gt = _face_video(rng, T, H, W, v)
            path = os.path.join(root, f"speaker{v}.avi")
            write_avi(path, frames, fps)
            json_path = os.path.join(root, f"speaker{v}.json")
            with open(json_path, "w", encoding="utf-8") as f:
                json.dump([{"Sentence_info": [
                    {"ID": i + 1, "topic": "synthetic", "sentence_text": "가나다",
                     "start_time": s, "end_time": e} for i, (s, e) in enumerate(spans)]}], f)
            found = []

            def detector(fr):
                boxes = detect_lip_boxes_auto(fr, margin)
                found.append(boxes)
                return boxes

            t0 = time.perf_counter()
            result = extract_clips(open_video(path), json_path, os.path.join(root, "clips"),
                                   f"speaker{v}", fps=fps, out_size=128, margin=margin,
                                   boxes_for_frames=detector)
            extract_s += time.perf_counter() - t0
            if result.skipped or len(result.saved) != len(spans):
                raise SystemExit(f"lip-extract: speaker {v}: saved {len(result.saved)}, "
                                 f"skipped {result.skipped}")
            worst = 1.0
            for (s, e), boxes in zip(spans, found):
                idx = range(int(s * fps), int(e * fps))
                n_frames += len(idx)
                for t, box in zip(idx, boxes):
                    g = gt[t]
                    inside = (box[0] <= g[0] and box[1] <= g[1] and box[2] >= g[2]
                              and box[3] >= g[3])
                    gx = (max(0, g[0] - margin), max(0, g[1] - margin), min(W, g[2] + margin),
                          min(H, g[3] + margin))
                    ix = max(0, min(box[2], gx[2]) - max(box[0], gx[0]))
                    iy = max(0, min(box[3], gx[3]) - max(box[1], gx[1]))
                    inter = ix * iy
                    area = lambda r: (r[2] - r[0]) * (r[3] - r[1])  # noqa: E731
                    score = inter / (area(box) + area(gx) - inter)
                    worst = min(worst, score)
                    if not inside or score < 0.5:
                        raise SystemExit(f"lip-extract: speaker {v} frame {t}: box {box} does "
                                         f"not follow the lips {g} (IoU {score:.3f})")
            truth[v] = worst
            clips[v] = [np.load(p) for p in result.saved]
        shapes = [c.shape for c in clips[1] + clips[2]]
        if any(c.dtype != np.uint8 or c.shape[1:] != (128, 128, 3) for c in clips[1] + clips[2]):
            raise SystemExit(f"lip-extract: clips {shapes}")
        log(f"[lip-extract] 2 AVIs of {T} frames {W}x{H} -> {len(shapes)} clips {shapes} "
            f"(uint8) by open_video + extract_clips with the "
            f"{'mediapipe' if have_mediapipe() else 'heuristic'} localizer: {n_frames} frames "
            f"in {extract_s:.2f} s, {n_frames / extract_s:.1f} frames/s; every box holds the "
            f"drawn lips, least IoU with lips+margin {min(truth.values()):.3f} (>= 0.5)")

        k2_err, times = 0.0, []
        for c in clips[1] + clips[2]:                # K2 at the clips' [T, 128, 128, 3]
            x = torch.from_numpy(c).cuda()
            got, ref = resize.lip_preprocess_cuda(x, 96), resize.lip_frames_preprocess(x, 96)
            k2_err = max(k2_err, (got - ref).abs().max().item())
            if not torch.allclose(got, ref, rtol=1e-4, atol=1e-3):
                raise SystemExit(f"lip-extract: K2 disagrees with its plain version at "
                                 f"{tuple(x.shape)}: {k2_err}")
            times.append(cuda_ms(resize.lip_preprocess_cuda, [(x, 96)], 50, graph=True))
        x = torch.from_numpy(clips[1][0]).cuda()
        b_ms, b_by = bound(x.shape[0] * 96 * 96 * (4 * 3 + 10),
                           x.numel() + x.shape[0] * 96 * 96 * 4)
        log(f"[lip-extract] K2 at the clips' [T, 128, 128, 3] uint8 (T {min(s[0] for s in shapes)}"
            f"-{max(s[0] for s in shapes)}): max|kernel-plain| {k2_err:.3g} (rtol 1e-4, atol "
            f"1e-3) ok; {min(times):.4f}-{max(times):.4f} ms per launch by graph replay; at "
            f"{tuple(x.shape)} {times[0]:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
            f"({b_ms / times[0]:.3f} of it)")

        specs = make_bucket_specs((64, 128), 534, 128)
        requests = []
        for i in range(len(spans)):
            s = {}
            for k in ("1", "2"):
                lip = clips[int(k)][i]
                n = lip.shape[0] * 534
                tt = np.arange(n) / 16000.0
                s["lip" + k + "_raw"] = lip
                s["audio" + k] = (0.3 * np.sin(2 * np.pi * (150 + 40 * i + 70 * int(k)) * tt)
                                  + 0.05 * rng.standard_normal(n)).astype(np.float32)
                s["label" + k] = rng.integers(4, 800, size=12)
            spec = pick_bucket(specs, max(c.shape[0] for c in (clips[1][i], clips[2][i])),
                               max(len(s["audio1"]), len(s["audio2"])))
            requests.append(collate_pairs_raw([s], spec))
        transcriber.transcribe(_flagship_batch(torch, requests[0]))     # warm-up
        torch.cuda.synchronize()
        since = launch_counts()
        lat, per_request, texts = [], [], []
        for raw in requests:                         # the main path
            before = launch_counts()
            t0 = time.perf_counter()
            texts += transcriber.transcribe(_flagship_batch(torch, raw))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            per_request.append(tuple(launch_counts(before).values())[:2])
        k1, k2, k3, k4 = launch_counts(since).values()
        log(f"[lip-extract] {len(requests)} requests from the extracted clips (B=1, buckets "
            f"{[r['lip1_raw'].shape[1] for r in requests]}): "
            f"{', '.join(f'{x * 1e3:.1f}' for x in lat)} ms; launches per request {per_request}; "
            f"first texts {json.dumps(texts[0])[:80]}; card {smi}")
        if (per_request != [(1, 2)] * len(requests) or len(texts) != len(requests)
                or k4 != 2 * len(requests)):
            raise SystemExit(f"lip-extract: launches per request {per_request}, K4 {k4} "
                             f"(expected 2 a request)")
        return {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def hostops_phase(torch) -> None:
    """[hostops]: the native host ops built from ``runtime/hostops.cpp`` and
    held against their numpy paths at the pipeline's shapes: 5 minutes of
    48 kHz 16-bit PCM decoded and resampled to 16 kHz, a 120-frame clip of
    128x128 crops resized to 96, the edit distances of 2,000 transcript
    pairs.  Fails if the library did not build."""
    from multimodal_av_model_tpu_torch.runtime import native

    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    if not native.have_native():
        raise SystemExit("hostops: the native library did not load")
    log(f"[hostops] {os.path.relpath(path, REPO)} built (or found) in {build_s:.2f} s")
    rng = np.random.default_rng(9)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, (time.perf_counter() - t0) * 1e3

    tt = np.arange(48000 * 300) / 48000.0
    pcm = (np.clip(0.3 * np.sin(2 * np.pi * 220 * tt) + 0.05 * rng.standard_normal(tt.size),
                   -1, 1) * 32767).astype(np.int16)
    clip = rng.integers(0, 256, size=(120, 128, 128)).astype(np.float32)
    alphabet = [chr(0xAC00 + i) for i in range(40)] + [" "]
    pairs = [("".join(rng.choice(alphabet, size=int(rng.integers(10, 60)))),
              "".join(rng.choice(alphabet, size=int(rng.integers(10, 60)))))
             for _ in range(2000)]
    checks = [
        ("pcm16 -> f32, 5 min at 48 kHz", (native.pcm16_to_f32, native.pcm16_to_f32_numpy),
         (pcm,), 1e-7, 0.0),
        ("resample 48 -> 16 kHz, 5 min", (native.resample_linear, native.resample_linear_numpy),
         (pcm.astype(np.float32) / 32768.0, 48000, 16000), 1e-6, 0.0),
        ("resize [120, 128, 128] -> 96", (native.resize_bilinear, native.resize_bilinear_numpy),
         (clip, 96, 96), 1e-3, 1e-5),
    ]
    ok = True
    for tag, (fast, plain), args, atol, rtol in checks:
        got, fast_ms = timed(fast, *args)
        want, plain_ms = timed(plain, *args)
        err = float(np.abs(got - want).max())
        good = got.shape == want.shape and bool(np.allclose(got, want, rtol=rtol, atol=atol))
        ok = ok and good
        log(f"[hostops] {tag}: native {fast_ms:.1f} ms, numpy {plain_ms:.1f} ms; shape "
            f"{got.shape}; max|native-numpy| {err:.3g} (atol {atol:g}, rtol {rtol:g}) "
            f"{'ok' if good else 'FAILED'}")
    got, fast_ms = timed(lambda: [native.levenshtein(a, b) for a, b in pairs])
    want, plain_ms = timed(lambda: [native.levenshtein_numpy(a, b) for a, b in pairs])
    ok = ok and got == want
    log(f"[hostops] levenshtein of {len(pairs)} transcript pairs (10-60 syllables): native "
        f"{fast_ms:.1f} ms, numpy {plain_ms:.1f} ms; distances equal {got == want}, total "
        f"{sum(got)}")
    if not ok:
        raise SystemExit("hostops: a native op disagrees with its numpy path")


def runtime_phase(torch, served) -> None:
    """[runtime]: ``trace`` of one [serving] request (its trace holds the
    ``annotate`` ranges and a K1 and a K2 launch), ``nan_guard`` on a forward
    with a NaN in the mixture, ``device_memory_stats``, and the kernels and
    host ops built twice in fresh processes under one ``compile_cache_dir``
    (the second finds them).  Runs after every other profiler session."""
    import glob
    import shutil
    import tempfile

    from multimodal_av_model_tpu_torch.ops import cuda_build
    from multimodal_av_model_tpu_torch.train.profiling import (
        annotate,
        device_memory_stats,
        nan_guard,
        trace,
    )

    transcriber, requests = served[0], served[1]
    root = tempfile.mkdtemp(prefix="mmav_runtime_")
    try:
        t0 = time.perf_counter()
        with trace(os.path.join(root, "trace")) as prof:
            with annotate("request"):
                with annotate("preprocess"):
                    batch = _flagship_batch(torch, requests[0])
                with annotate("transcribe"):
                    texts = transcriber.transcribe(batch)
        dt = time.perf_counter() - t0
        files = glob.glob(os.path.join(root, "trace", "*.pt.trace.json"))
        text = open(files[0]).read() if len(files) == 1 else ""
        names = {e.key for e in prof.key_averages()}
        want = ["request", "preprocess", "transcribe", "logmel_kernel", "lip_kernel"]
        missing = [w for w in want if f'"{w}' not in text and not any(w in n for n in names)]
        log(f"[runtime] trace of one bucket-128 request: {len(files)} file "
            f"{os.path.getsize(files[0]) / 1e6 if files else 0:.1f} MB, {len(names)} named "
            f"events, {dt:.2f} s under the profiler; holds {want}: "
            f"{'ok' if not missing and len(texts) == 4 else f'MISSING {missing}'}")
        if missing or len(texts) != 4:
            raise SystemExit(f"runtime: the trace lacks {missing} ({len(texts)} texts)")

        bad = dict(batch)
        bad["audio"] = batch["audio"].clone()
        bad["audio"][0, 1000] = float("nan")
        try:
            with nan_guard():
                transcriber.transcribe(bad)
            caught = None
        except FloatingPointError as e:
            caught = str(e)
        log(f"[runtime] nan_guard on a forward with one NaN sample: "
            f"{caught or 'NOT CAUGHT'}; anomaly mode after: {torch.is_anomaly_enabled()}")
        if caught is None or torch.is_anomaly_enabled():
            raise SystemExit("runtime: nan_guard did not trap the NaN or left anomaly mode on")

        stats = device_memory_stats()
        peak = (stats.get("cuda:0") or {}).get("allocated_bytes.all.peak")
        log(f"[runtime] device_memory_stats: {sorted(stats)}, cuda:0 "
            f"{len(stats.get('cuda:0') or {})} counters, allocated peak "
            f"{(peak or 0) / 2**30:.2f} GiB")
        if peak is None:
            raise SystemExit(f"runtime: device_memory_stats gave {list(stats)}")

        cache = os.path.join(root, "cache")
        code = ("import json, sys, time; sys.path.insert(0, sys.argv[2]); "
                "from multimodal_av_model_tpu_torch.runtime.compile_cache import "
                "enable_compile_cache; from multimodal_av_model_tpu_torch.ops import cuda_build; "
                "from multimodal_av_model_tpu_torch.runtime import native; "
                "enable_compile_cache(sys.argv[1]); t = time.perf_counter(); cuda_build.build(); "
                "native.build(); print(json.dumps({'s': time.perf_counter() - t, "
                "'ok': native.have_native()}))")
        runs = []
        for _ in range(2):
            out = subprocess.run([sys.executable, "-c", code, cache, REPO], capture_output=True,
                                 text=True, timeout=600, check=True)
            runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        built = sorted(os.path.relpath(p, cache) for p in glob.glob(f"{cache}/*/*.so"))
        log(f"[runtime] compile_cache_dir: a fresh process built {built} in {runs[0]['s']:.2f} s, "
            f"a second one found them in {runs[1]['s']:.3f} s")
        # One library a kernel source and one of the host ops.
        if (len(built) != len(cuda_build.SOURCES) + 1 or not all(r["ok"] for r in runs)
                or runs[1]["s"] > 1.0):
            raise SystemExit(f"runtime: compile cache {built} {runs}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_rank_nccl() -> None:
    """A world-size-1 NCCL process group on a free local port."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)


def dist_phase(torch, rng, tok, smi: str, n_steps: int = 8) -> dict:
    """[dist]: the flagship's meshed training step at full width on a
    world-size-1 NCCL group and a (1, 1) mesh with FSDP: one step against
    the unmeshed ``train_step`` from the same state (loss, ``grad_norm``,
    every gradient at [train-ref]'s bars), then ``n_steps`` timed steps of
    each (raw batch -> ``device_preprocessed_batches`` -> ``shard_batch`` ->
    FSDP forward and backward -> Adam), a sharded checkpoint written and
    restored into a fresh meshed state and into the unmeshed one."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from multimodal_av_model_tpu_torch.config import Config, torch_dtype
    from multimodal_av_model_tpu_torch.data.collate import make_bucket_specs
    from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
    from multimodal_av_model_tpu_torch.ops import launch_counts
    from multimodal_av_model_tpu_torch.parallel import full_tensor, make_mesh
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer
    from multimodal_av_model_tpu_torch.train.checkpoints import host_snapshot
    from multimodal_av_model_tpu_torch.train.sharded_checkpoints import (
        restore_sharded,
        save_sharded,
    )

    _one_rank_nccl()
    root = tempfile.mkdtemp(prefix="mmav_dist_")
    try:
        mesh = make_mesh(model_parallel=1, device_type="cuda")
        cfg = Config()
        spec = make_bucket_specs((128,), cfg.data.audio_samples_per_video_frame,
                                 cfg.data.max_label_len)[0]
        raw = make_train_batch(rng, 8, spec)
        train_kernel_check(torch, 8, raw, "dist")

        def trainer(meshed):
            model = MultiSpeakerAVModel(cfg.model, torch_dtype(cfg.model.dtype))
            t = MultiSpeakerTrainer(cfg, model, tok, mesh=mesh if meshed else None,
                                    fsdp=meshed)
            return t, t.init_state(cfg.data.seed)

        (plain, p_state), (meshed, m_state) = trainer(False), trainer(True)
        (batch,) = device_preprocessed_batches([raw])
        _, m_plain = plain.train_step(p_state, batch)
        _, m_mesh = meshed.train_step(m_state, batch)
        g_plain = {n: p.grad.float() for n, p in p_state.model.named_parameters()
                   if p.grad is not None}
        g_mesh = {n: full_tensor(p.grad).float() for n, p in m_state.model.named_parameters()
                  if p.grad is not None}
        lp, lm = m_plain["loss"].item(), m_mesh["loss"].item()
        gp, gm = m_plain["grad_norm"].item(), m_mesh["grad_norm"].item()
        floor = 1e-3 * gp
        g_rel, g_name = max((float((g_mesh[n] - g).norm() / (g.norm() + floor)), n)
                            for n, g in g_plain.items())
        ok = (set(g_mesh) == set(g_plain) and abs(lm - lp) <= 1e-3 * abs(lp)
              and abs(gm - gp) <= 1e-2 * gp and g_rel <= 1e-2)
        placement = next(iter(m_state.model.parameters())).placements
        log(f"[dist] world 1 (nccl), mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}, FSDP "
            f"(parameters {placement}): one step against the unmeshed step from the same "
            f"state: loss {lm:.6f} vs {lp:.6f}, grad_norm {gm:.4f} vs {gp:.4f}, max per-tensor "
            f"gradient rel {g_rel:.3g} at {g_name} (bars of [train-ref]) "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise SystemExit("dist: the meshed step disagrees with the unmeshed one")
        del g_plain, g_mesh

        def steps(t, state):
            for _ in range(2):
                (b,) = device_preprocessed_batches([raw])
                t.train_step(state, b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            since = launch_counts()
            times, losses = [], []
            for _ in range(n_steps):                # the main path when counted
                t0 = time.perf_counter()
                (b,) = device_preprocessed_batches([raw])
                _, m = t.train_step(state, b)
                losses.append(m["loss"].item())
                times.append(time.perf_counter() - t0)
            k = tuple(launch_counts(since).values())
            return times, losses, torch.cuda.max_memory_allocated(), k

        for tag, t, state, count in (("unmeshed", plain, p_state, False),
                                     ("meshed FSDP", meshed, m_state, True)):
            times, losses, peak, (k1, k2, k3, k4) = steps(t, state)
            log(f"[dist] {tag} B=8: {n_steps} steps, {np.median(times) * 1e3:.1f} ms median "
                f"({min(times) * 1e3:.1f}-{max(times) * 1e3:.1f}), "
                f"{8 * n_steps / sum(times):.2f} utt/s, peak device memory "
                f"{peak / 2**30:.2f} GiB, loss {losses[0]:.4f} -> {losses[-1]:.4f}"
                + (f"; launches per step K1 {k1 / n_steps:g}, K2 {k2 / n_steps:g}, K4 "
                   f"{k4 / n_steps:g}" if count else ""))
            if not all(math.isfinite(x) for x in losses):
                raise SystemExit(f"dist: non-finite losses {losses}")
        if (k1, k2, k4) != (n_steps, 2 * n_steps, 4 * n_steps):
            raise SystemExit(f"dist: launches K1 {k1}, K2 {k2}, K4 {k4} over {n_steps} steps")
        launches = {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}

        ckpt = os.path.join(root, "sharded")
        t0 = time.perf_counter()
        save_sharded(ckpt, {"state": m_state, "epoch": 1})
        save_s = time.perf_counter() - t0
        saved = host_snapshot(m_state)
        fresh, f_state = trainer(True)
        t0 = time.perf_counter()
        back = restore_sharded(ckpt, {"state": f_state, "epoch": 0})
        load_s = time.perf_counter() - t0
        restore_sharded(ckpt, {"state": p_state, "epoch": 0})
        mismatch = [k for snap in (host_snapshot(f_state), host_snapshot(p_state))
                    for k, v in _flat(snap).items() if not _same(v, _flat(saved)[k])]
        nbytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        log(f"[dist] sharded checkpoint: {nbytes / 1e6:.0f} MB written in {save_s:.2f} s, "
            f"restored into a fresh meshed state in {load_s:.2f} s and into the unmeshed "
            f"state; epoch {back['epoch']}; tensors equal: "
            f"{'all' if not mismatch else mismatch[:5]}")
        if mismatch or back["epoch"] != 1:
            raise SystemExit("dist: the sharded checkpoint did not restore equal")
        log(f"[dist] card {smi}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
        dist.destroy_process_group()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _same(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def cli_child(argv: list[str]) -> int:
    """``chip_smoke.py --cli-child <args>``, run by ``torchrun``: the port's
    CLI (``multimodal_av_model_tpu_torch.main.main``) with the kernels'
    launches counted around it, then one ``[cli-child]`` JSON line with the
    launches, the train steps and the peak device memory."""
    import torch

    sys.path.insert(0, REPO)
    from multimodal_av_model_tpu_torch import main as cli
    from multimodal_av_model_tpu_torch.ops import launch_counts
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer

    n = {"train_step": 0}
    step = MultiSpeakerTrainer.train_step

    def counted(self, *args, **kwargs):
        n["train_step"] += 1
        return step(self, *args, **kwargs)

    MultiSpeakerTrainer.train_step = counted
    since = launch_counts()
    cli.main(argv)
    k1, k2, k3, k4 = launch_counts(since).values()
    print("[cli-child] " + json.dumps({
        "k1": k1, "k2": k2, "k3": k3, "k4": k4, "train_steps": n["train_step"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
    return 0


def dist_cli_phase(torch, tok, smi: str) -> dict:
    """[dist-cli]: ``torchrun --standalone --nproc-per-node=1`` of the port's
    CLI at full width with ``mesh.fsdp=true train.checkpoint_layout=sharded``
    on a corpus written as [fit]'s: one epoch, then a resume to epoch 2 (it
    must print ``resuming from``), then one epoch with ``mesh.model_axis=1
    mesh.fsdp=false``.  Each call's seconds, peak memory and launches (K1 1
    and K2 2 per train step and eval batch)."""
    import shutil
    import tempfile

    from multimodal_av_model_tpu_torch.config import Config
    from multimodal_av_model_tpu_torch.data.synth_corpus import write_synthetic_corpus

    root = tempfile.mkdtemp(prefix="mmav_dist_cli_")
    try:
        dirs = write_synthetic_corpus(os.path.join(root, "corpus"), tok, n_videos=8,
                                      sentences_per_video=6, sentence_dur=(3.0, 4.2), seed=0)
        vocab = os.path.join(REPO, Config().data.vocab_path)
        common = ([f"data.{k}={v}" for k, v in dirs.items()]
                  + [f"data.vocab_path={vocab}", "train.batch_size=8", "train.eval_batch_size=4",
                     "data.num_pairs_per_epoch=32", "data.eval_pairs=8",
                     "train.checkpoint_layout=sharded", "--device=cuda"])
        launches = {"logmel": 0, "lip_preprocess": 0, "prefix_beam": 0, "lstm_scan": 0}
        for tag, extra, want in (
                ("mesh.fsdp=true, 1 epoch", ["mesh.fsdp=true", "train.max_epochs=1", "a"], None),
                ("mesh.fsdp=true, resume to epoch 2", ["mesh.fsdp=true", "train.max_epochs=2",
                                                       "a"], "resuming from"),
                ("mesh.model_axis=1 mesh.fsdp=false, 1 epoch",
                 ["mesh.model_axis=1", "mesh.fsdp=false", "train.max_epochs=1", "b"], None)):
            args = common + extra[:-1] + [f"train.checkpoint_dir={os.path.join(root, extra[-1])}"]
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node=1", os.path.join(REPO, "chip_smoke.py"), "--cli-child", *args],
                capture_output=True, text=True, timeout=600, cwd=REPO)
            dt = time.perf_counter() - t0
            out = proc.stdout
            if proc.returncode != 0:
                print(out[-4000:], proc.stderr[-4000:], sep="\n", flush=True)
                raise SystemExit(f"dist-cli: {tag} exited {proc.returncode}")
            child = json.loads(next(ln for ln in out.splitlines()
                                    if ln.startswith("[cli-child] "))[len("[cli-child] "):])
            epochs = [ln for ln in out.splitlines() if ln.startswith("[epoch ")]
            mesh_line = next((ln for ln in out.splitlines() if ln.startswith("mesh: ")), "")
            n_eval = 2 * len(epochs)                # 8 eval pairs at B = 4 per epoch
            calls = child["train_steps"] + n_eval
            log(f"[dist-cli] {tag}: {dt:.1f} s (torchrun, one process); {mesh_line[:90]}; peak "
                f"device memory {child['peak_gib']:.2f} GiB; {child['train_steps']} train steps, "
                f"{n_eval} eval batches; launches K1 {child['k1']}, K2 {child['k2']}, K3 "
                f"{child['k3']}, K4 {child['k4']}; "
                f"{epochs[-1][:100] if epochs else 'NO EPOCH'}")
            if want and want not in out:
                raise SystemExit(f"dist-cli: {tag} did not print {want!r}")
            if (not epochs or not mesh_line or child["k1"] != calls or child["k2"] != 2 * calls
                    or child["k4"] != 4 * child["train_steps"] + 2 * n_eval):
                raise SystemExit(f"dist-cli: {tag}: epochs {len(epochs)}, launches {child} "
                                 f"(K4 4 a train step, 2 an eval batch)")
            launches = add_launches(launches, (child[k] for k in ("k1", "k2", "k3", "k4")))
        log(f"[dist-cli] card {smi}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def longform_phase(torch, rng, smi: str, n_calls: int = 3) -> dict:
    """[longform]: K1 against its plain version at a 120 s and a 960 s
    stream; then, on a world-size-1 NCCL group and its (1, 1) mesh, the
    long-form encoder (``make_cp_audio_encoder``, the flagship's 12 x 512
    Conformer in f32, seeded weights) with ``impl="ring"`` and
    ``impl="gather"`` against the full-attention ``AudioEncoder`` on the same
    parameters and one pad-free 120 s stream: ``last`` and ``middle`` at
    JAX's long-form bars (atol 2e-4, rtol 1e-4), each encoder's median ms
    per call and peak memory, and K1's launches over the CP calls (the main
    path): one per call."""
    import torch.distributed as dist

    from multimodal_av_model_tpu_torch.config import Config
    from multimodal_av_model_tpu_torch.models import AudioEncoder, init_weights
    from multimodal_av_model_tpu_torch.parallel import make_cp_audio_encoder, make_mesh

    cfg = Config().model
    sr = cfg.frontend.sample_rate
    for seconds in (120, 960):
        x = torch.from_numpy(_waveform(rng, seconds * sr)[None]).cuda()
        k1_at(torch, x, "longform")
        del x
    wave = torch.from_numpy(_waveform(rng, 120 * sr)[None]).cuda()
    T_enc = AudioEncoder.output_length(cfg.audio, cfg.frontend, wave.shape[1])
    _one_rank_nccl()
    try:
        mesh = make_mesh(model_parallel=1, device_type="cuda")
        full = init_weights(AudioEncoder(cfg.audio, cfg.frontend),
                            torch.Generator().manual_seed(0)).cuda().eval()
        encoders = {"full attention": full}
        for impl in ("ring", "gather"):
            enc = make_cp_audio_encoder(cfg, mesh, "data", impl).cuda().eval()
            enc.load_state_dict(full.state_dict())
            encoders[impl] = enc
        outs, k1, k2, k3, k4 = {}, 0, 0, 0, 0
        for name, enc in encoders.items():
            with torch.no_grad():
                outs[name] = enc(wave)
                times, _, n1, n2, n3, n4, peak = _timed_steps(
                    torch, lambda: enc(wave)[0].sum(), 0, n_calls)
            if name != "full attention":            # the main path
                k1, k2, k3, k4 = k1 + n1, k2 + n2, k3 + n3, k4 + n4
            ms, peak = float(np.median(times)) * 1e3, peak / 2**30
            last, middle, _ = outs[name]
            ref_last, ref_middle, _ = outs["full attention"]
            errs = [(a - b).abs().max().item() for a, b in ((last, ref_last),
                                                            (middle, ref_middle))]
            ok = all(torch.allclose(a, b, rtol=1e-4, atol=2e-4) for a, b in
                     ((last, ref_last), (middle, ref_middle)))
            ok = ok and bool(torch.isfinite(last).all())
            log(f"[longform] {name}: [1, {wave.shape[1]}] (120 s) -> last {tuple(last.shape)}, "
                f"T_enc {T_enc}; {ms:.1f} ms per call (median of {n_calls}), peak device "
                f"memory {peak:.2f} GiB; max|diff| to full attention: last {errs[0]:.3g}, "
                f"middle {errs[1]:.3g} (atol 2e-4, rtol 1e-4) {'ok' if ok else 'FAILED'}")
            if not ok:
                raise SystemExit(f"longform: {name} disagrees with the full-attention encoder")
        calls = 2 * n_calls
        log(f"[longform] launches over the {calls} timed CP encoder calls: K1 {k1}, K2 {k2}; "
            f"card {smi}")
        if (k1, k2, k4) != (calls, 0, 0):
            raise SystemExit(f"longform: launches K1 {k1}, K2 {k2}, K4 {k4} over {calls} calls")
        return {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}
    finally:
        dist.destroy_process_group()


def pp_phase(torch, rng, smi: str, n_steps: int = 5, microbatches: int = 4) -> dict:
    """[pp]: on a world-size-1 NCCL group and its (1, 1) ``("data", "pipe")``
    mesh, the flagship's 12 Conformer blocks (d 512, 8 heads, FFN 2048,
    kernel 15, f32, seeded weights) as one stage, ``pipeline_blocks`` with
    ``microbatches`` microbatches on B = 8 rows of ``bench.py``'s 120 frames
    (64,080 samples: 201 encoder frames, random lengths) against the blocks
    applied in turn: the forward within 2e-5 and every parameter's gradient
    of ``sum(y * valid)`` at rtol 5e-4, atol 5e-5 (JAX's PP bars); then the
    median ms of a forward and backward of each, peak memory, and the
    launches over the pipelined steps (the main path: none)."""
    import torch.distributed as dist
    from torch import nn

    from multimodal_av_model_tpu_torch.config import Config
    from multimodal_av_model_tpu_torch.models import AudioEncoder, init_weights
    from multimodal_av_model_tpu_torch.models.audio import ConformerBlock
    from multimodal_av_model_tpu_torch.parallel import (
        PIPE_AXIS,
        bubble_fraction,
        make_named_mesh,
        pipeline_blocks,
        shard_stacked_params,
        stack_block_params,
    )

    cfg = Config().model
    a = cfg.audio
    _one_rank_nccl()
    try:
        mesh = make_named_mesh((1, 1), ("data", PIPE_AXIS), "cuda")

        def block():
            return ConformerBlock(a.d_model, a.num_heads, a.ffn_dim, a.conv_kernel_size,
                                  a.dropout, torch.float32)

        seq = init_weights(nn.ModuleList(block() for _ in range(a.num_layers)),
                           torch.Generator().manual_seed(0)).cuda().eval()
        stacked = stack_block_params({f"blocks.{k}": v for k, v in seq.state_dict().items()},
                                     a.num_layers)
        stage = shard_stacked_params(stacked, mesh, block).cuda().eval()
        B, S = 8, 120 * 534
        T = AudioEncoder.output_length(a, cfg.frontend, S)
        x = torch.from_numpy(rng.standard_normal((B, T, a.d_model)).astype(np.float32)).cuda()
        lens = torch.from_numpy(rng.integers(T // 2, T + 1, size=B)).cuda()
        valid = torch.arange(T, device="cuda")[None] < lens[:, None]
        amask = valid[:, None, None, :] & valid[:, None, :, None]

        def pipelined():
            y = pipeline_blocks(stage, x, valid, amask, mesh, microbatches)
            (y * valid[..., None]).sum().backward()
            return y

        def sequential():
            h = x
            for b in seq:
                h = b(h, valid, amask)
            (h * valid[..., None]).sum().backward()
            return h

        y_pp, y_seq = pipelined().detach(), sequential().detach()
        fwd_err = (y_pp - y_seq).abs().max().item()
        ok = torch.allclose(y_pp, y_seq, rtol=2e-5, atol=2e-5)
        g_seq = stack_block_params({f"blocks.{n}": p.grad for n, p in seq.named_parameters()},
                                   a.num_layers)
        g_pp = stack_block_params({f"blocks.{n}": p.grad for n, p in stage.named_parameters()},
                                  a.num_layers)
        worst, worst_at = 0.0, ""
        for n, g in g_seq.items():
            excess = ((g_pp[n] - g).abs() / (5e-5 + 5e-4 * g.abs())).max().item()
            if excess > worst:
                worst, worst_at = excess, n
        ok = ok and worst <= 1.0
        log(f"[pp] {a.num_layers} blocks x {a.d_model} (f32) as 1 stage, B={B}, T={T}, "
            f"M={microbatches}: pipelined vs sequential forward max|diff| {fwd_err:.3g} "
            f"(2e-5); gradients of sum(y*valid), {len(g_seq)} stacked tensors, worst at "
            f"{worst:.3g} of its bar (rtol 5e-4, atol 5e-5) at {worst_at} "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise SystemExit("pp: the pipelined tower disagrees with the sequential one")
        del y_pp, y_seq, g_seq, g_pp
        for tag, fn, module in (("sequential", sequential, seq),
                                ("pipelined", pipelined, stage)):   # the main path last
            def step(fn=fn, module=module):
                module.zero_grad(set_to_none=True)
                return fn().detach().sum()

            times, _, k1, k2, k3, k4, peak = _timed_steps(torch, step, 1, n_steps)
            log(f"[pp] {tag}: forward + backward {float(np.median(times)) * 1e3:.1f} ms "
                f"(median of {n_steps}), peak device memory {peak / 2**30:.2f} GiB")
        launches = {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}
        log(f"[pp] bubble_fraction(1, {microbatches}) = {bubble_fraction(1, microbatches):g} "
            f"(4 stages: {bubble_fraction(4, microbatches):.4f}); launches over the pipelined "
            f"steps K1 {launches['logmel']}, K2 {launches['lip_preprocess']}; card {smi}")
        if any(launches.values()):
            raise SystemExit(f"pp: kernels launched on the tower: {launches}")
        return launches
    finally:
        dist.destroy_process_group()



def shared_pass_phase(torch, rng, tok, smi: str) -> dict:
    """[shared-pass]: ``model.shared_audio_pass=false``, the reference-shaped
    double audio pass (the encoder on ``[2B]`` rows, K1 once on ``[2B, S]``).
    A small f32 check, card against CPU: the double pass against the shared
    pass in eval with the same parameters, log-probs compared and prefix-beam
    ids held exactly; then at full width one bucket-128 request of 4
    mixtures served with the double pass, and the B = 8 training step at
    ``bench.py``'s shapes: each pass alone (2 warm-up, 5 timed steps, the
    allocator's device calls, one step with the recorder on), then both alive, 2
    warm-up and 5 timed steps of each in turns (shared, double, double,
    shared), with FLOPs by ``FlopCounterMode`` (the audio encoder's forward
    doubles).  Returns the double pass's launches (request and the timed
    steps in turns)."""
    from torch.utils.flop_counter import FlopCounterMode

    from multimodal_av_model_tpu_torch.config import Config, torch_dtype
    from multimodal_av_model_tpu_torch.data.collate import make_bucket_specs
    from multimodal_av_model_tpu_torch.data.device_pipeline import (
        device_preprocessed_batches,
        preprocess_batch_device,
    )
    from multimodal_av_model_tpu_torch.infer import Transcriber, decode_ids
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel, init_weights
    from multimodal_av_model_tpu_torch.ops import launch_counts
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer
    from multimodal_av_model_tpu_torch.train.trainer import place_batch

    tag = "shared-pass"
    # Small f32: the double pass on the card against the CPU and against the
    # shared pass, one set of parameters.
    cfg = tiny_model_config()
    spec = make_bucket_specs((16,), 534, 8)[0]
    raw = make_request(rng, 2, spec, crop=48)
    shared = init_weights(MultiSpeakerAVModel(cfg.model), torch.Generator().manual_seed(1))
    cfg_d = tiny_model_config()
    cfg_d.model.shared_audio_pass = False
    double = MultiSpeakerAVModel(cfg_d.model)
    double.load_state_dict(shared.state_dict())
    keys = ("lip1", "lip2", "audio", "mask1", "mask2", "lip1_lengths", "lip2_lengths")
    outs = {}
    for dev in ("cpu", "cuda"):
        batch = preprocess_batch_device(raw["lip1_raw"], raw["lip2_raw"], raw["audio1"],
                                        raw["audio2"], raw["audio1_len"], raw["audio2_len"],
                                        out_size=24, device=dev)
        batch["lip1_lengths"] = torch.from_numpy(raw["lip1_lengths"]).to(dev)
        batch["lip2_lengths"] = torch.from_numpy(raw["lip2_lengths"]).to(dev)
        for name, m in (("shared", shared), ("double", double)):
            with torch.no_grad():
                outs[dev, name] = m.to(dev).eval()(*[batch[k] for k in keys])

    def valid_err(a, b):
        err = 0.0
        for s in ("1", "2"):
            if not torch.equal(a["input_lengths" + s].cpu(), b["input_lengths" + s].cpu()):
                raise SystemExit(f"{tag}: input_lengths differ")
            for r, n in enumerate(b["input_lengths" + s].tolist()):
                d = a["log_probs" + s][r, :n].cpu() - b["log_probs" + s][r, :n].cpu()
                err = max(err, d.abs().max().item() if n else 0.0)
        return err

    def ids(o):
        lp = torch.cat([o["log_probs1"], o["log_probs2"]])
        out, n = decode_ids(cfg, lp, torch.cat([o["input_lengths1"], o["input_lengths2"]]))
        return out.cpu(), n.cpu()

    card_cpu = valid_err(outs["cuda", "double"], outs["cpu", "double"])
    double_shared = valid_err(outs["cuda", "double"], outs["cuda", "shared"])
    ref_ids = ids(outs["cpu", "double"])
    same = all(torch.equal(a, b) for o in (outs["cuda", "double"], outs["cuda", "shared"])
               for a, b in zip(ids(o), ref_ids))
    ok = card_cpu <= 1e-3 and double_shared <= 1e-4 and same
    log(f"[{tag}] small f32 model, eval, the double pass: card vs CPU max|log_probs| on valid "
        f"frames {card_cpu:.3g} (<= 1e-3); vs the shared pass on the card {double_shared:.3g} "
        f"(<= 1e-4); prefix-beam ids of both passes on the card "
        f"{'equal' if same else 'DIFFER from'} the CPU's {'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{tag}: small check failed")
    del shared, double, outs

    # Full width: one bucket-128 request of 4 mixtures served with the double pass.
    launches = {"logmel": 0, "lip_preprocess": 0, "prefix_beam": 0, "lstm_scan": 0}
    cfg = Config()
    cfg.model.shared_audio_pass = False
    dtype = torch_dtype(cfg.model.dtype)
    model = init_weights(MultiSpeakerAVModel(cfg.model, dtype), torch.Generator().manual_seed(0))
    transcriber = Transcriber(cfg, tok, model, device="cuda")
    spec = make_bucket_specs((128,), cfg.data.audio_samples_per_video_frame,
                             cfg.data.max_label_len)[0]
    raw = make_request(rng, 4, spec)
    request = _flagship_batch(torch, raw)
    k1_at(torch, torch.cat([request["audio"]] * 2).float().contiguous(), tag)
    captured = []
    hook = model.register_forward_hook(lambda mod, args, out: captured.append(out))
    transcriber.transcribe(_flagship_batch(torch, raw))                 # warm-up
    torch.cuda.synchronize()
    captured.clear()
    torch.cuda.reset_peak_memory_stats()
    since = launch_counts()
    t0 = time.perf_counter()                                            # the main path
    texts = transcriber.transcribe(_flagship_batch(torch, raw))
    torch.cuda.synchronize()
    req_ms = (time.perf_counter() - t0) * 1e3
    k1, k2, k3, k4 = launch_counts(since).values()
    hook.remove()
    for s in ("1", "2"):
        lp = captured[0]["log_probs" + s].float()
        if (lp.shape != (4, 128, cfg.model.decoder.vocab_size) or not torch.isfinite(lp).all()
                or (lp.logsumexp(-1).abs() > 1e-3).any()):
            raise SystemExit(f"{tag}: bad log-probs {tuple(lp.shape)}")
    log(f"[{tag}] full width, double pass: one bucket-128 request of 4 mixtures in "
        f"{req_ms:.1f} ms, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB, launches K1 {k1} K2 {k2} K3 {k3} K4 {k4}; first texts "
        f"{json.dumps(texts[0])[:80]}")
    if (k1, k2, k3, k4) != (1, 2, 1, 2) or len(texts) != 4:
        raise SystemExit(f"{tag}: request launches K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4} "
                         f"(expected 1, 2, 1 and 2)")
    launches = add_launches(launches, (k1, k2, k3, k4))
    del transcriber, model, captured

    # Full width: the B = 8 step of each pass on bench.py's shapes.
    raw = make_train_batch(rng, 8, spec)
    (batch,) = device_preprocessed_batches([raw])
    k1_at(torch, torch.cat([batch["audio"]] * 2).float().contiguous(), tag)
    del batch

    def make_step(shared_pass: bool):
        cfg = Config()
        cfg.model.shared_audio_pass = shared_pass
        trainer = MultiSpeakerTrainer(
            cfg, MultiSpeakerAVModel(cfg.model, torch_dtype(cfg.model.dtype)), tok)
        state = trainer.init_state(cfg.data.seed)

        def step():
            (b,) = device_preprocessed_batches([raw])
            return trainer.train_step(state, b)[1]["loss"]

        for _ in range(2):                              # warm-up
            step()
        return step, state

    def allocator_calls():
        s = torch.cuda.memory_stats()
        return np.array([s.get("num_device_alloc", 0), s.get("num_device_free", 0)])

    # Each pass alone (only its trainer alive), the double pass built first:
    # 5 timed steps, the caching allocator's cudaMalloc / cudaFree calls over
    # them, and one step with the recorder on.
    alone = {}
    for name in ("double", "shared"):
        step = make_step(name == "shared")[0]
        before = allocator_calls()
        times, *_, peak = _timed_steps(torch, step, 0, 5)
        calls = allocator_calls() - before
        alone[name] = times
        log(f"[{tag}] B=8 {name} pass alone: {_ms(times)} per step; peak device memory "
            f"{peak / 2**30:.2f} GiB; device cudaMalloc / cudaFree over the 5 steps "
            f"{calls[0]} / {calls[1]}")
        traced(torch, tag, f"one B=8 step of the {name} pass alone", step)
        del step
        gc.collect()
        torch.cuda.empty_cache()

    # Both trainers alive, the shared pass built first, in turns (shared,
    # double, double, shared): the main path.
    rows = {}
    for name, shared_pass in (("shared", True), ("double", False)):
        step, state = make_step(shared_pass)
        rows[name] = {"step": step, "state": state, "times": [], "losses": [], "k1": 0,
                      "k2": 0, "k3": 0, "k4": 0, "peak": 0, "calls": np.zeros(2, np.int64)}
    for name in ("shared", "double", "double", "shared"):   # in turns; the main path
        r = rows[name]
        before = allocator_calls()
        times, losses, k1, k2, k3, k4, peak = _timed_steps(torch, r["step"], 0, 5)
        r["calls"] += allocator_calls() - before
        r["times"] += times
        r["losses"] += losses
        r["k1"], r["k2"], r["peak"] = r["k1"] + k1, r["k2"] + k2, max(r["peak"], peak)
        r["k3"], r["k4"] = r["k3"] + k3, r["k4"] + k4
    for name, r in rows.items():
        with FlopCounterMode(display=False) as counter:
            r["step"]()
            torch.cuda.synchronize()
        r["flops"] = counter.get_total_flops()
        b = place_batch(next(device_preprocessed_batches([raw])), "cuda")
        with FlopCounterMode(display=False) as fwd, torch.no_grad():
            r["state"].model(*[b[k] for k in keys], train=True, generator=r["state"].generator)
        r["enc"] = sum(sum(v.values()) for k, v in fwd.get_flop_counts().items()
                       if k.split(".")[-1] == "audio_encoder")
        times, losses, n = r["times"], r["losses"], len(r["times"])
        log(f"[{tag}] B=8 {name} pass, 2 x 5 timed steps in turns with the other (both "
            f"trainers alive): {_ms(times)} per step, {8 * n / sum(times):.2f} utt/s; device "
            f"cudaMalloc / cudaFree over them {r['calls'][0]} / {r['calls'][1]}; peak device "
            f"memory {r['peak'] / 2**30:.2f} GiB; {r['flops'] / 1e12:.3f} TFLOP a step, the "
            f"audio encoder's forward {r['enc'] / 1e12:.4f} TFLOP (FlopCounterMode); launches "
            f"per step K1 {r['k1'] / n:g}, K2 {r['k2'] / n:g}, K4 {r['k4'] / n:g}; loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        if (r["k1"], r["k2"], r["k4"]) != (n, 2 * n, 4 * n):
            raise SystemExit(f"{tag}: {name} pass launches K1 {r['k1']}, K2 {r['k2']}, K4 "
                             f"{r['k4']} over {n} steps (expected 1, 2 and 4 per step)")
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"{tag}: non-finite losses {losses}")
    launches = add_launches(launches, (rows["double"][k] for k in ("k1", "k2", "k3", "k4")))
    ratio = rows["double"]["enc"] / rows["shared"]["enc"]
    cost = np.median(rows["double"]["times"]) / np.median(rows["shared"]["times"])
    cost_alone = np.median(alone["double"]) / np.median(alone["shared"])
    log(f"[{tag}] double against shared at B=8: audio encoder forward FLOPs x{ratio:.3f}, step "
        f"FLOPs x{rows['double']['flops'] / rows['shared']['flops']:.3f}, median step "
        f"x{cost_alone:.3f} alone, x{cost:.3f} in turns with both alive; card {smi}")
    if not 1.99 <= ratio <= 2.01:
        raise SystemExit(f"{tag}: the audio encoder's FLOPs did not double (x{ratio:.3f})")
    return launches


def raw_media_phase(torch, tok, smi: str) -> dict:
    """[raw-media]: the raw-media corpus written by the port's
    ``write_raw_media_corpus`` (4 videos x 4 sentences of 2 s, 320x240 AVIs
    at 30 fps with a moving mouth patch and its boxes, 48 kHz stereo WAVs),
    128x128x3 crops by ``extract_clips`` from the precomputed boxes,
    ``save_all_sentence_labels`` and ``build_data_list``; then 3 flagship
    training steps at full width, B = 8 speaker-distinct pairs a step,
    through ``load_pair_raw`` -> ``collate_pairs_raw`` ->
    ``device_preprocessed_batches`` (K2 x2) -> ``train_step`` (K1 x1), with
    K1 and K2 held against their plain versions at these clips' shapes."""
    import shutil
    import tempfile

    from multimodal_av_model_tpu_torch.config import Config, torch_dtype
    from multimodal_av_model_tpu_torch.data.avi import avi_frame_reader
    from multimodal_av_model_tpu_torch.data.collate import collate_pairs_raw, make_bucket_specs
    from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches
    from multimodal_av_model_tpu_torch.data.lip_extract import extract_clips
    from multimodal_av_model_tpu_torch.data.manifest import (
        build_data_list,
        save_all_sentence_labels,
        speaker_id_of,
    )
    from multimodal_av_model_tpu_torch.data.pipeline import FilePairSource
    from multimodal_av_model_tpu_torch.data.synth_corpus import write_raw_media_corpus
    from multimodal_av_model_tpu_torch.models import MultiSpeakerAVModel
    from multimodal_av_model_tpu_torch.ops import launch_counts
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer

    tag = "raw-media"
    root = tempfile.mkdtemp(prefix="mmav_raw_media_")
    try:
        t0 = time.perf_counter()
        dirs = write_raw_media_corpus(root, tok, n_videos=4, sentences_per_video=4,
                                      width=320, height=240, sentence_dur=2.0, gap=0.3,
                                      seed=0)
        write_s = time.perf_counter() - t0
        mb = sum(os.path.getsize(os.path.join(d, f)) for d in (dirs["video_dir"], dirs["wav_dir"])
                 for f in os.listdir(d)) / 1e6
        t0 = time.perf_counter()
        clips = []
        for name in sorted(os.listdir(dirs["json_folder"])):
            base = name[:-len(".json")]
            boxes = np.load(os.path.join(dirs["boxes_dir"], base + "_boxes.npy"))
            res = extract_clips(avi_frame_reader(os.path.join(dirs["video_dir"], base + ".avi")),
                                os.path.join(dirs["json_folder"], name), dirs["npy_dir"], base,
                                fps=30, out_size=128,
                                boxes_for_range=lambda s, e, b=boxes: b[s:e])
            if res.skipped or len(res.saved) != 4:
                raise SystemExit(f"{tag}: {base}: saved {len(res.saved)}, skipped {res.skipped}")
            clips += res.saved
        extract_s = time.perf_counter() - t0
        n_labels = save_all_sentence_labels(dirs["json_folder"], dirs["text_dir"])
        entries, skipped = build_data_list(dirs["json_folder"], dirs["npy_dir"],
                                           dirs["text_dir"], dirs["wav_dir"])
        if n_labels != 16 or len(entries) != 16 or skipped:
            raise SystemExit(f"{tag}: {n_labels} labels, {len(entries)} entries, {skipped}")
        shapes = sorted({np.load(p, mmap_mode="r").shape for p in clips})
        log(f"[{tag}] corpus: 4 AVIs of 320x240 at 30 fps and 4 stereo 48 kHz WAVs, {mb:.1f} MB, "
            f"written in {write_s:.2f} s; 16 clips {shapes} uint8 extracted from the boxes in "
            f"{extract_s:.2f} s; {n_labels} labels, manifest of {len(entries)} entries")

        cfg = Config()
        spec = make_bucket_specs((64,), cfg.data.audio_samples_per_video_frame,
                                 cfg.data.max_label_len)[0]
        source = FilePairSource(tok, cfg.data.sample_rate)
        raws = []
        for offset in (4, 8, 12):                       # speaker = video: entries 4v..4v+3
            pairs = [(entries[k], entries[(k + offset) % 16]) for k in range(8)]
            if any(speaker_id_of(a.lip_path) == speaker_id_of(b.lip_path) for a, b in pairs):
                raise SystemExit(f"{tag}: a pair of one speaker")
            raws.append(collate_pairs_raw([source.load_pair_raw(a, b) for a, b in pairs], spec))
        train_kernel_check(torch, 8, raws[0], tag)

        trainer = MultiSpeakerTrainer(
            cfg, MultiSpeakerAVModel(cfg.model, torch_dtype(cfg.model.dtype)), tok)
        state = trainer.init_state(cfg.data.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        since = launch_counts()
        times, pulls, losses = [], [], []
        batches = device_preprocessed_batches(raws)     # the main path
        for _ in raws:
            t0 = time.perf_counter()                    # the batch's copies and K2 included
            b = next(batches)
            torch.cuda.synchronize()
            pulls.append(time.perf_counter() - t0)
            state, m = trainer.train_step(state, b)
            losses.append(m["loss"].item())
            times.append(time.perf_counter() - t0)
        k1, k2, k3, k4 = launch_counts(since).values()
        log(f"[{tag}] 3 flagship steps at full width (B=8 speaker-distinct pairs, bucket 64): "
            f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms (the first with cuDNN's warm-up; "
            f"each from the pull of its raw batch, of which the pull, its host-to-device "
            f"copies, mixing and K2, took {', '.join(f'{x * 1e3:.1f}' for x in pulls)} ms); "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; launches K1 {k1} K2 {k2} K4 {k4}; card "
            f"{smi}")
        if (k1, k2, k4) != (3, 6, 12):
            raise SystemExit(f"{tag}: launches K1 {k1}, K2 {k2}, K4 {k4} over 3 steps (expected "
                             f"1, 2 and 4 per step)")
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"{tag}: non-finite losses {losses}")
        return {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def whisper_flamingo_phase(torch, rng, smi: str, B: int = 16, frames: int = 240,
                           bucket: int = 256, device: str = "cuda") -> dict:
    """[whisper-flamingo]: one ``MultiSpeakerTrainer.train_step`` of
    ``model.arch=whisper_flamingo`` on ``B`` = 16 mixtures at K1's and K2's
    shapes of the benchmark's cell (the mixture padded to Whisper's 30 s
    window, ``[16, 480000]`` at 80 Slaney bins; ``[16, 256]`` clips of
    128x128x3 crops to 88x88) with the widths cut (2 + 2 Whisper layers of
    256, a 2-layer video encoder of 256, Whisper's vocabulary): after one
    warm-up step, the launches of one pull of the batch and its step (K1 1,
    K2 2), and K1 in Slaney mode with ``whisper_log_mel`` after it against
    their plain versions on that step's own mixture, at the bars of
    ``test_logmel_kernel_at_80_slaney_bins``."""
    from multimodal_av_model_tpu_torch.config import Config, torch_dtype
    from multimodal_av_model_tpu_torch.data.collate import make_bucket_specs
    from multimodal_av_model_tpu_torch.data.device_pipeline import device_preprocessed_batches
    from multimodal_av_model_tpu_torch.models import build_av_model
    from multimodal_av_model_tpu_torch.models.whisper_flamingo import pipeline_options
    from multimodal_av_model_tpu_torch.ops import launch_counts, logmel
    from multimodal_av_model_tpu_torch.train import MultiSpeakerTrainer

    tag = "whisper-flamingo"
    cfg = Config()
    m = cfg.model
    m.arch, m.frontend.n_mels, m.frontend.mel_scale = "whisper_flamingo", 80, "slaney"
    w = m.whisper_flamingo
    w.n_audio_state = w.n_text_state = w.video_dim = 256
    w.n_audio_head = w.n_text_head = 4
    w.n_audio_layer = w.n_text_layer = 2
    a = m.avhubert
    a.embed_dim, a.num_layers, a.num_heads, a.ffn_dim, a.conv_pos = 256, 2, 4, 1024, 16
    a.dropout = a.attention_dropout = a.activation_dropout = 0.0
    m.visual.output_dim = 256
    cfg.data.audio_samples_per_video_frame = 640
    spec = make_bucket_specs((bucket,), 640, 60)[0]
    raws = [make_train_batch(rng, B, spec, crop=128, frames=frames, label_len=40,
                             vocab=w.eot) for _ in range(2)]
    trainer = MultiSpeakerTrainer(cfg, build_av_model(m, torch_dtype(m.dtype)), None,
                                  device=device)
    state = trainer.init_state(0)
    options = pipeline_options(m)
    pull = device_preprocessed_batches(raws, out_size=88, device=device, **options)
    state, _ = trainer.train_step(state, next(pull))          # the warm-up step
    torch.cuda.synchronize()
    since = launch_counts()
    batch = next(pull)
    state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    k1, k2, k3, k4 = launch_counts(since).values()
    audio = batch["audio"]
    fe = m.frontend
    kw = dict(n_mels=80, apply_log=False, mel_scale="slaney")
    got = logmel.log_mel_spectrogram_cuda(audio, **kw)
    ref = logmel.log_mel_spectrogram(audio, **kw)
    frames_w = 2 * w.n_audio_ctx
    err = float((got - ref).abs().max())
    feat_err = float((logmel.whisper_log_mel(got, frames_w)
                      - logmel.whisper_log_mel(ref, frames_w)).abs().max())
    ok_mel = torch.allclose(got, ref, rtol=2e-3, atol=1e-2)
    ok_feat = torch.allclose(logmel.whisper_log_mel(got, frames_w),
                             logmel.whisper_log_mel(ref, frames_w), rtol=2e-3, atol=2e-3)
    loss = float(metrics["loss"])
    log(f"[{tag}] one train_step of model.arch=whisper_flamingo (widths cut, K1 and K2 at the "
        f"cell's shapes): mixture {tuple(audio.shape)} (window {options['window']}), lips "
        f"{tuple(batch['lip1'].shape)}, decoder rows {tuple(batch['tokens1'].shape)}; loss "
        f"{loss:.4f}; launches K1 {k1} K2 {k2} K3 {k3} K4 {k4}; K1 slaney "
        f"{tuple(got.shape)} max|kernel-plain| {err:.3g} (rtol 2e-3, atol 1e-2) "
        f"{'ok' if ok_mel else 'FAILED'}; whisper_log_mel max gap {feat_err:.3g} (rtol=atol="
        f"2e-3) {'ok' if ok_feat else 'FAILED'}; card {smi}")
    if tuple(audio.shape) != (B, options["window"]) or (k1, k2, k3, k4) != (1, 2, 0, 0):
        raise SystemExit(f"{tag}: mixture {tuple(audio.shape)}, launches K1 {k1} K2 {k2} K3 "
                         f"{k3} K4 {k4} (expected [{B}, {options['window']}], 1, 2, 0, 0)")
    if not (ok_mel and ok_feat and math.isfinite(loss)):
        raise SystemExit(f"{tag}: K1 {err}, features {feat_err}, loss {loss}")
    return {"logmel": k1, "lip_preprocess": k2, "prefix_beam": k3, "lstm_scan": k4}


PHASES = ("k3", "family-ref", "family-audio", "family-visual", "families", "legacy-ref", "legacy",
          "reference-import", "lip-extract", "hostops", "runtime", "dist", "dist-cli", "longform",
          "pp", "shared-pass", "raw-media", "k4", "whisper-flamingo")
UPSTREAM = PHASES[5:9]


def upstream_phases(torch, rng, tok, smi: str, only=UPSTREAM) -> dict:
    """[legacy-ref], [legacy], [reference-import] and [lip-extract] (those
    of ``only``; [lip-extract] serves from [reference-import]'s model, so it
    brings that phase along) -> each main path's launches."""
    out = {}
    if "legacy-ref" in only:
        legacy_ref_phase(torch)
    if "legacy" in only:
        out["legacy"] = legacy_phase(torch, tok, smi)
    if "reference-import" in only or "lip-extract" in only:
        out["reference_import"], transcriber = reference_import_phase(torch, rng, tok, smi)
    if "lip-extract" in only:
        out["lip_extract"] = lip_extract_phase(torch, rng, tok, transcriber, smi)
    return out


def train_profile(torch, step) -> None:
    """One B = 8 training step (after one more to warm the caching allocator
    again after the B = 32 steps) with the recorder on."""
    step()
    traced(torch, "train-profile", "one B=8 training step", step)


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--cli-child"]:
        return cli_child(sys.argv[2:])
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:] if a.startswith("--only=")]
    only = only[0] if only else None
    if only and not set(only) <= set(PHASES):
        print(f"chip_smoke: --only takes some of {','.join(PHASES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from multimodal_av_model_tpu_torch.config import Config
    from multimodal_av_model_tpu_torch.ops import cuda_build
    from multimodal_av_model_tpu_torch.text import CharTokenizer

    # Features and the f32 reference are held at full f32: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name} | "
        f"count {torch.cuda.device_count()} | matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    logs = cuda_build.build()
    for k, text in logs.items():
        info = [ln.strip()[:160] for ln in text.splitlines()
                if "registers" in ln or "spill" in ln or "Performance Loss" in ln]
        log(f"[build] {k}: " + (" | ".join(info) or text.strip()[:200]))
    log(f"[build] {len(logs)} kernels built in {time.perf_counter() - t0:.1f} s (sm_90a)")

    rng = np.random.default_rng(0)
    tok = CharTokenizer(os.path.join(REPO, Config().data.vocab_path))
    if only:                                # a rehearsal of some phases alone
        for name in only:
            if name in UPSTREAM:
                continue
            {"k3": lambda: k3_phase(torch, rng),
             "k4": lambda: k4_phase(torch, rng),
             "family-ref": lambda: family_ref_phase(torch, tok),
             "family-audio": lambda: family_audio_phase(torch, tok, smi),
             "family-visual": lambda: family_visual_phase(torch, tok, smi),
             "families": lambda: families_phase(torch, tok, smi),
             "hostops": lambda: hostops_phase(torch),
             "runtime": lambda: runtime_phase(torch, serving_phase(torch, rng, tok)[2]),
             "dist": lambda: dist_phase(torch, rng, tok, smi),
             "dist-cli": lambda: dist_cli_phase(torch, tok, smi),
             "longform": lambda: longform_phase(torch, rng, smi),
             "pp": lambda: pp_phase(torch, rng, smi),
             "shared-pass": lambda: shared_pass_phase(torch, rng, tok, smi),
             "raw-media": lambda: raw_media_phase(torch, tok, smi),
             "whisper-flamingo": lambda: whisper_flamingo_phase(torch, rng, smi)}[name]()
        if set(only) & set(UPSTREAM):
            upstream_phases(torch, rng, tok, smi, only)
        log(f"[partial] {','.join(only)} done; no kernels JSON and no result line")
        return 0
    hostops_phase(torch)
    (k1, k1_calls), (k2, k2_calls) = k1_phase(torch, rng), k2_phase(torch, rng)
    k3, k4 = k3_phase(torch, rng), k4_phase(torch, rng)
    reference_phase(torch, rng)
    serving_launches, profile_request, served = serving_phase(torch, rng, tok)
    beam_ref_phase(torch, served)
    quant_launches = quant_phase(torch, served)
    stream_ref_phase(torch, rng, tok)
    stream_launches, audio_model = stream_audio_phase(torch, rng, tok)
    serve_launches = serve_phase(torch, rng, tok, audio_model)
    del audio_model
    stream_av_launches = stream_av_phase(torch, tok, smi)
    train_ref_phase(torch, rng, tok)
    train_launches, train_step = train_phase(torch, rng, tok)
    fit_launches = fit_phase(torch, tok, smi)
    export_launches = export_phase(torch, served)
    tf_launches = temporal_tf_phase(torch, rng, tok)
    structured_launches = structured_phase(torch, tok, smi)
    family_ref_phase(torch, tok)
    family_audio_launches = family_audio_phase(torch, tok, smi)
    family_visual_launches = family_visual_phase(torch, tok, smi)
    families_launches = families_phase(torch, tok, smi)
    upstream_launches = upstream_phases(torch, rng, tok, smi)
    dist_launches = dist_phase(torch, rng, tok, smi)
    dist_cli_launches = dist_cli_phase(torch, tok, smi)
    longform_launches = longform_phase(torch, rng, smi)
    pp_launches = pp_phase(torch, rng, smi)
    shared_pass_launches = shared_pass_phase(torch, rng, tok, smi)
    raw_media_launches = raw_media_phase(torch, tok, smi)
    whisper_flamingo_launches = whisper_flamingo_phase(torch, rng, smi)
    kernels = [k1, k2, k3, k4]
    for tag, k, calls in (("k1", k1, k1_calls), ("k2", k2, k2_calls), ("k3", k3, None),
                          ("k4", k4, None)):
        by_path = {"serving": serving_launches[k["name"]], "train": train_launches[k["name"]],
                   "fit": fit_launches[k["name"]],
                   "stream_audio": stream_launches["stream_audio"][k["name"]],
                   "pool": stream_launches["pool"][k["name"]],
                   "stream_av": stream_av_launches[k["name"]], "quant": quant_launches[k["name"]],
                   "serve": serve_launches[k["name"]], "export": export_launches[k["name"]],
                   "temporal_tf": tf_launches[k["name"]],
                   "structured": structured_launches[k["name"]],
                   "family_audio": family_audio_launches[k["name"]],
                   "family_visual": family_visual_launches[k["name"]],
                   "ssl": families_launches["ssl"][k["name"]],
                   "families_cli": families_launches["families_cli"][k["name"]],
                   "legacy": upstream_launches["legacy"][k["name"]],
                   "reference_import": upstream_launches["reference_import"][k["name"]],
                   "lip_extract": upstream_launches["lip_extract"][k["name"]],
                   "dist": dist_launches[k["name"]], "dist_cli": dist_cli_launches[k["name"]],
                   "longform": longform_launches[k["name"]], "pp": pp_launches[k["name"]],
                   "shared_pass": shared_pass_launches[k["name"]],
                   "raw_media": raw_media_launches[k["name"]],
                   "whisper_flamingo": whisper_flamingo_launches[k["name"]]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        if calls is None:                           # K3, K4: graph replay's time only
            continue
        dev_ms, caught = profiled_ms(*calls)
        log(f"[{tag}] device time per launch by torch.profiler (CUPTI), mean of the {caught} "
            f"of {calls[2]} launches issued one by one that it caught: {dev_ms:.4f} ms, "
            f"{dev_ms / k['ms']:.3f} of the graph-replay {k['ms']:.4f} ms")
    profile_request()
    train_profile(torch, train_step)
    runtime_phase(torch, served)
    del served
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
