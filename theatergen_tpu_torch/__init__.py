"""PyTorch/CUDA port of theatergen_tpu for NVIDIA Hopper (H100).

Plain tensor code is PyTorch; the Pallas kernels of the JAX package are
hand-written CUDA kernels under ``csrc/``, built on first use by
:mod:`._build`.  Module paths mirror ``theatergen_tpu`` one to one.
"""
