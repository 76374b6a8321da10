"""The Whisper-Flamingo training step's share of the card's dense bf16 peak:
the work the recipe must do, counted from the configuration and shapes
(avbench/flops_whisper_flamingo.py: every forward, the decoder's and the
gated blocks' activation gradients, the trainables' weight gradients, no
backward of the frozen encoders), times the steps of the traced window, over
its seconds and 989 TFLOP/s, in %."""

from .mfu import read  # noqa: F401  (the runner's flops_per_unit is flops_whisper_flamingo's)
