"""PyTorch/CUDA port of the multi-precision division system.

The JAX package `repro` is its bit-for-bit reference; this package
imports torch and never jax.
"""
