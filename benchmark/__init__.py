"""The benchmark of the PyTorch and CUDA port (``gb25_tpu_torch``)."""
