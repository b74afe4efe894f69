"""Device choice and the numerics policy of the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
card and no explicit request they raise instead of dropping to the CPU.

Every entry point computes under one numerics policy,
:func:`set_numerics`, which :func:`resolve_device` applies and each
``__main__`` and each rank of ``parallel/launch.py`` applies before its
first tensor: fp32 is fp32 on the card (no TF32 in cuBLAS or cuDNN), and
cuDNN takes only its deterministic algorithms, so that a seeded run gives
the same bits in one process and across processes.  There is no switch.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def set_numerics() -> None:
    """The port's numerics, the same for ``precision: 32`` and ``bf16``.

    * TF32 off in cuBLAS and cuDNN: an fp32 product or conv is the fp32
      function the CPU reference computes (a new process starts with
      cuDNN's TF32 on, whose 10-bit mantissa is another function);
    * cuDNN's deterministic algorithms, chosen by its heuristics rather
      than by timing (``benchmark`` off): the same inputs give the same
      bits on every call and in every process.

    Harmless on the CPU, where none of these is read."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent.  Sets
    the numerics policy (:func:`set_numerics`) first."""
    set_numerics()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
