"""Preprocessing of the Whisper-Flamingo step (data/device_pipeline.py: H2D
of the raw batch, mixing, the mixture padded to Whisper's 30 s window, K2 on
both speakers, the decoder's rows from
``models/whisper_flamingo.pipeline_options``): host clock around the call,
synchronised before and after, ms per step."""

from .preprocess_ms import read  # noqa: F401
