"""multimodal_av_model_tpu_torch: the PyTorch / CUDA port of multimodal_av_model_tpu.

The JAX package ``multimodal_av_model_tpu`` stays the reference; this package
mirrors its layout and names, imports nothing from it, and runs on an NVIDIA
H100.  Its two hand-written CUDA kernels (``csrc/``) replace the JAX package's
two Pallas kernels.  The serving path, the training step and the training
run so far:

    main.py     the command line: train (fit), --eval, --infer, --synthetic
    data/       the AI-Hub manifest and split, speaker-distinct pairs, WAV
                decode and resampling, bucketed collation, the prefetching
                host pipeline, on-device mixing + lip preprocessing (K2)
    ops/        log-mel frontend (K1), bilinear resize (K2), CTC loss, collapse
                and greedy decode, prefix beam search, the masked contrastive
                loss, WER/CER counts, the kernels' nvcc build step
    models/     AudioEncoder, VisualEncoder, CrossAttentionFusion, CTCDecoder,
                MultiSpeakerAVModel (train and eval)
    train/      MultiSpeakerTrainer (train/eval steps, epoch loop, evaluate,
                fit), two-group Adam, checkpoints (async, averaged), CSV and
                TensorBoard logs, preemption, the finite-metrics guard
    compat/     flax variables and TrainState -> state_dict bridge
    text/       character tokenizer, jamo counts
    infer.py    Transcriber: checkpoint or weights, batch -> per-speaker texts

Entry points run on the card unless the caller passes ``device="cpu"``; the
path through each kernel is chosen by the tensor's device alone.
"""

__version__ = "0.1.0"
