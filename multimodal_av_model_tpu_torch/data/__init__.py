"""Data: the AI-Hub corpus manifest, WAV decode and resampling, pair
sampling, bucketed collation (raw and processed), the prefetching host
pipeline, on-device mixing and lip preprocessing (K2), a synthetic corpus
writer, AVI and baseline JPEG decode, offline lip extraction and the legacy
family's sample directories."""

from .avi import open_video
from .legacy_preprocess import build_all_pair_samples, build_pair_sample
from .lip_extract import ExtractionResult, extract_clips

__all__ = ["ExtractionResult", "build_all_pair_samples", "build_pair_sample", "extract_clips",
           "open_video"]
