"""Host-side native data ops (``native.py``) and the build cache of the
port's compiled libraries (``compile_cache.py``)."""

from .native import (
    have_native,
    levenshtein,
    mix_and_mask,
    pcm16_to_f32,
    resample_linear,
    resize_bilinear,
)

__all__ = ["have_native", "levenshtein", "mix_and_mask", "pcm16_to_f32", "resample_linear",
           "resize_bilinear"]
