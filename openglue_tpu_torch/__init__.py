"""PyTorch/CUDA port of the openglue_tpu matcher.

The JAX package ``openglue_tpu`` is the reference; this package computes the
same functions in PyTorch and replaces its Pallas TPU kernels with CUDA
kernels written for Hopper (``ops/csrc``). Module names follow the JAX
package so each module's counterpart is easy to find. Nothing here imports
``jax`` or ``openglue_tpu``.
"""
