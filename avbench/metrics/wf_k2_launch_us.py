"""K2 (csrc/lip_preprocess.cu) in the Whisper-Flamingo step: mean device
time of its launches in the profiled stretch (two a step, one a speaker's
``[16, 256]`` clips of 128 x 128 x 3 crops to 88 x 88 grey), in
microseconds."""

from .k2_launch_us import read  # noqa: F401
