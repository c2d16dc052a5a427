"""BLEST benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100."""
