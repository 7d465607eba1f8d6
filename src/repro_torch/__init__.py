"""PyTorch + CUDA port of the `repro` serving system, for NVIDIA Hopper.

The JAX package `repro` is the reference; this package imports nothing of
it (nor `jax`).  Module names follow the reference so each counterpart is
easy to find.  Entry points run on the CUDA device unless the caller asks
for the CPU, where every kernel wrapper takes its plain PyTorch version.
"""
