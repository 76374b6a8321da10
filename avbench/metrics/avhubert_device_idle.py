"""The device's idle share of the AV-HuBERT step's profiled stretch: 1 -
(union of the device operations' intervals) / (host clock over the
stretch), in %."""

from .device_idle import read  # noqa: F401
