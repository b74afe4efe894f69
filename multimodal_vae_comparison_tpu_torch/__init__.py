"""PyTorch/CUDA port of multimodal_vae_comparison_tpu.

The JAX package beside this one is the reference.  This package mirrors its
module names, keeps its layouts at public functions (NHWC images,
(B, H, T, Dh) attention, (E, ..., D) experts), and replaces each of its
Pallas TPU kernels with a CUDA kernel for Hopper (``csrc/``), each with a
plain PyTorch version beside it that CPU tensors take.  It imports neither
JAX nor the JAX package.
"""
