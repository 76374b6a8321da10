"""The device's idle share of the Whisper-Flamingo step's profiled stretch: 1 -
(union of the device operations' intervals) / (host clock over the
stretch), in %."""

from .device_idle import read  # noqa: F401
