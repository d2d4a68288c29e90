"""The benchmark of the PyTorch / CUDA SaP solver (``repro_torch``)."""
