"""Kernels written by hand for Hopper, one per TPU kernel of the JAX package.

Each kernel directory holds ``csrc/<name>.cu`` (CUDA C++ with a plain C
interface, built by :mod:`._build`), ``ops.py`` (the wrapper: checks,
launch, launch counter; the plain version for CPU tensors) and
``ref.py`` (the plain PyTorch version).
"""
