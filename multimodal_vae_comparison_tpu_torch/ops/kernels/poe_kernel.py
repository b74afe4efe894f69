"""Product-of-experts precision fusion: CUDA kernel and its plain version.

Counterpart of ``ops/pallas/poe_kernel.py`` (``poe_fused``).  The kernel is
``csrc/poe.cu``; :func:`poe_reference` is the same function in plain
PyTorch.  :func:`poe_fused` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors.  Serving needs no gradient, so a
CUDA input that requires one raises; the training slice adds the
closed-form backward of ``_poe_bwd`` as a ``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes

import torch

from multimodal_vae_comparison_tpu_torch.constants import EPS
from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, telemetry

KERNEL = "poe"
# poe_forward(mus, scales, mu_out, scale_out, n, experts, p0, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p]


def poe_reference(mus: torch.Tensor, scales: torch.Tensor,
                  prior_precision: float = 1.0):
    """Plain PyTorch PoE fusion: (E, ..., D) experts -> (mu, scale) (..., D)."""
    precision = 1.0 / (scales.square() + EPS)
    denom = precision.sum(0) + prior_precision
    mu = (mus * precision).sum(0) / denom
    return mu, torch.sqrt(1.0 / denom)


def _launch(mus: torch.Tensor, scales: torch.Tensor, prior_precision: float):
    if mus.dtype != torch.float32 or scales.dtype != torch.float32:
        raise TypeError(f"poe kernel takes float32, got {mus.dtype}, {scales.dtype}")
    if mus.shape != scales.shape or mus.dim() < 2:
        raise ValueError(f"poe kernel takes equal (E, ..., D) shapes, got "
                         f"{tuple(mus.shape)} and {tuple(scales.shape)}")
    if mus.device != scales.device:
        raise ValueError("mus and scales lie on different devices")
    if not (mus.is_contiguous() and scales.is_contiguous()):
        raise ValueError("poe kernel takes contiguous tensors")
    if torch.is_grad_enabled() and (mus.requires_grad or scales.requires_grad):
        raise NotImplementedError(
            "the CUDA poe kernel has no backward yet; it comes with the "
            "training slice (an autograd Function mirroring _poe_bwd)")
    fn = _build.function(KERNEL, "poe_forward", _ARGTYPES)
    experts = mus.shape[0]
    mu = torch.empty(mus.shape[1:], dtype=torch.float32, device=mus.device)
    scale = torch.empty_like(mu)
    stream = torch.cuda.current_stream(mus.device).cuda_stream
    err = fn(mus.data_ptr(), scales.data_ptr(), mu.data_ptr(), scale.data_ptr(),
             mu.numel(), experts, float(prior_precision), stream)
    _build.check(KERNEL, err)
    telemetry.count_launch(KERNEL)
    return mu, scale


def poe_fused(mus: torch.Tensor, scales: torch.Tensor,
              prior_precision: float = 1.0):
    """PoE fusion: CUDA kernel for CUDA tensors, plain version for CPU ones.

    :param mus: (E, ..., D) expert means
    :param scales: (E, ..., D) expert stddevs
    :return: (mu, scale) of the product Gaussian, shape (..., D)
    """
    if mus.is_cuda:
        telemetry.record(KERNEL, "cuda")
        return _launch(mus, scales, prior_precision)
    if mus.device.type != "cpu":
        raise ValueError(f"poe_fused runs on CUDA or the CPU, not {mus.device}")
    telemetry.record(KERNEL, "plain")
    return poe_reference(mus, scales, prior_precision)
