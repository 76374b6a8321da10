"""multimodal_av_model_tpu_torch: the PyTorch / CUDA port of multimodal_av_model_tpu.

The JAX package ``multimodal_av_model_tpu`` stays the reference; this package
mirrors its layout and names, imports nothing from it, and runs on an NVIDIA
H100.  Its two hand-written CUDA kernels (``csrc/``) replace the JAX package's
two Pallas kernels.  The serving surface, the training step and the
training runs of the flagship, audio-only, visual-only, SSL and legacy
families, the upstream reference's checkpoint import and offline lip
extraction so far:

    main.py     the command line: train (fit), --eval, --infer, --synthetic,
                --family=av|audio|visual|ssl, --stream (one WAV, a pool of
                WAVs, or two AVIs and a WAV)
    data/       the AI-Hub manifest and split, speaker-distinct pairs, WAV
                decode and resampling, bucketed collation, the prefetching
                host pipeline, on-device mixing + lip preprocessing (K2),
                AVI and baseline JPEG decode, offline lip extraction, the
                legacy family's sample directories
    ops/        log-mel frontend (K1), bilinear resize (K2), CTC loss, collapse
                and greedy decode, prefix beam search (offline and streaming),
                the reference path beam, int8 weight-only quantization, the
                masked contrastive loss, SpecAugment, the masked-span
                InfoNCE, WER/CER counts, the kernels' nvcc build step
    models/     AudioEncoder, VisualEncoder, CrossAttentionFusion, CTCDecoder,
                MultiSpeakerAVModel, AudioOnlyCTC, VisualOnlyCTC, the legacy
                MultimodalCTCKoreanModel (BiGRU)
    train/      MultiSpeakerTrainer (train/eval steps, epoch loop, evaluate,
                fit), SingleModalityTrainer (audio and visual families),
                MaskedAudioPretrainer (SSL), LegacyTrainer and the legacy
                sample reader, two-group Adam, checkpoints
                (async, averaged), CSV and TensorBoard logs, preemption, the
                finite-metrics guard
    compat/     flax variables and train states -> state_dict bridge; upstream
                reference checkpoints -> the flagship's state_dict
    text/       character tokenizer, the Korean syllable vocabulary, jamo
                counts, the bigram LM
    infer.py    Transcriber (batch -> per-speaker texts), AudioTranscriber,
                fp or int8
    streaming.py  audio, AV and pooled streaming transcribers
    serve.py    dynamic batching, the audio service, an HTTP front end

Entry points run on the card unless the caller passes ``device="cpu"``; the
path through each kernel is chosen by the tensor's device alone.
"""

__version__ = "0.1.0"
