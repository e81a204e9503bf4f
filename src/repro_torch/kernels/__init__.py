"""Hand-written CUDA kernels of the port, one package per reference kernel.

Each package keeps the reference's three layers: ``ref.py`` (plain PyTorch,
runs anywhere), ``kernel.py`` (the ctypes wrapper of ``csrc/*.cu``, CUDA
tensors only, with a launch counter) and ``ops.py`` (dispatch on the impl
name; a kernel impl on CPU tensors takes the plain version).
"""
