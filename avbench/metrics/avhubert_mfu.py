"""The AV-HuBERT training step's share of the card's dense bf16 peak: the
model's operations counted from the configuration and shapes
(avbench/flops_avhubert.py) times the steps of the traced window, over its
seconds and 989 TFLOP/s, in %."""

from .mfu import read  # noqa: F401  (the runner's flops_per_unit is flops_avhubert's)
