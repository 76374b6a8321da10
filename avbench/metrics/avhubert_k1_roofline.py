"""K1 at AV-HuBERT's 26 bins (csrc/logmel.cu, the 48-bin mel supports) against
its roofline, at the traffic's ``[B, S]`` mixtures: least time (bytes in and
out, or the FFT and the 26-bin mel projection's operations at the f32 peak;
``roofline.k1``) over the mean profiled device time of a launch, in %."""

from .k1_roofline import read  # noqa: F401  (the runner's kernel_work counts 26 bins)
