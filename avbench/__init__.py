"""The benchmark harness of the PyTorch and CUDA port (``multimodal_av_model_tpu_torch``)."""
