"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``); see README.md."""
