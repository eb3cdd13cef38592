"""Hand-written CUDA kernels of the port (``csrc/``), their wrappers and
their plain PyTorch versions (``ref.py``).  Nothing builds at import: a
kernel compiles at its first launch (``build.py``)."""
