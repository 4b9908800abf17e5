"""PyTorch + CUDA port of the SmartPQ reproduction (`src/repro`).

The JAX package `repro` is the reference; every module here names its
counterpart.  Importing this package imports torch and numpy, never jax.
"""
