"""Hand-written CUDA kernels of the port, each with its plain version.

Each module's entry point launches its kernel for CUDA tensors and takes the
plain PyTorch version only for CPU tensors; sources live in ``csrc/`` and
are built by :mod:`._build` at first use.
"""
