"""Data: the AI-Hub corpus manifest, WAV decode and resampling, pair
sampling, bucketed collation (raw and processed), the prefetching host
pipeline, on-device mixing and lip preprocessing (K2), a synthetic corpus
writer, and AVI and baseline JPEG decode."""
