"""K1 at Whisper's 80 Slaney bins (csrc/logmel.cu) against its roofline, on
the ``[16, 480000]`` window: least time (bytes in and out, or the FFT and the
mel projection's operations at the f32 peak;
``flops_whisper_flamingo.k1``) over the mean profiled device time of a
launch, in %."""

from .k1_roofline import read  # noqa: F401  (the runner's kernel_work counts the Slaney bins)
