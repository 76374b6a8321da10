"""The benchmark's plain reference of the two-speaker audio-visual CTC model.

Plain PyTorch in float32 (TF32 off where it runs on a card), written from the
model's published equations as functions of a flat state dict, so the same
named tensors that the benchmark loads into the system under test drive it.
It imports nothing of the system under test and nothing of JAX:

* ``preprocess``: two-speaker mixing and masks, lip frames to grey 96x96,
  the log-mel frontend;
* ``model``: the visual encoder, the Conformer, the fusion (BiLSTM or
  transformer temporal model) and the CTC head, eval or train mode;
* ``train``: the losses of one training step and two-group Adam;
* ``decode``: CTC prefix beam search in float64, and ids to text.

``lowp`` in ``model`` runs every product of the forward on float8 (e4m3)
inputs: the control that a precision below the configuration's bfloat16
must fail.
"""
