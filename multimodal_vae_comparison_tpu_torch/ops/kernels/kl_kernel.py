"""KL(N(mu, scale) || N(0, 1)) over the latents: CUDA kernel and plain version.

Counterpart of ``ops/pallas/kl_kernel.py`` (``kl_normal_std_fused``).  The
kernel is ``csrc/kl.cu``; :func:`kl_reference` is the same function in
plain PyTorch.  :func:`kl_normal_std_fused` is a ``torch.autograd.Function``
whose forward launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; its backward is the closed form of the
reference's ``_kl_bwd``, in torch ops, as the JAX package computes it
outside any Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, telemetry

KERNEL = "kl"
# kl_forward(mu, scale, out, rows, d, stream)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]


def kl_reference(mu: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sum_D KL(N(mu, scale) || N(0, 1)): (..., D) -> (...)."""
    var = scale.square()
    return (0.5 * (var + mu.square() - 1.0 - torch.log(var))).sum(-1)


def _launch(mu: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if mu.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"kl kernel takes float32, got {mu.dtype}, {scale.dtype}")
    if mu.shape != scale.shape or mu.dim() < 1 or mu.numel() == 0:
        raise ValueError(f"kl kernel takes equal non-empty (..., D) shapes, got "
                         f"{tuple(mu.shape)} and {tuple(scale.shape)}")
    if mu.device != scale.device:
        raise ValueError("mu and scale lie on different devices")
    if not (mu.is_contiguous() and scale.is_contiguous()):
        raise ValueError("kl kernel takes contiguous tensors")
    d = mu.shape[-1]
    fn = _build.function(KERNEL, "kl_forward", _ARGTYPES)
    out = torch.empty(mu.shape[:-1], dtype=torch.float32, device=mu.device)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    err = fn(mu.data_ptr(), scale.data_ptr(), out.data_ptr(), mu.numel() // d,
             d, stream)
    _build.check(KERNEL, err)
    telemetry.count_launch(KERNEL)
    return out


class _KLStd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, scale):
        ctx.save_for_backward(mu, scale)
        if mu.is_cuda:
            telemetry.record(KERNEL, "cuda")
            return _launch(mu, scale)
        telemetry.record(KERNEL, "plain")
        return kl_reference(mu, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mu, scale = ctx.saved_tensors
        g = g[..., None]
        return g * mu, g * (scale - 1.0 / scale)


def kl_normal_std_fused(mu: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """sum_D KL(N(mu, scale) || N(0, 1)): the CUDA kernel for CUDA tensors,
    the plain version for CPU ones; gradients by the closed form.

    :param mu, scale: (..., D) float32
    :return: (...) float32
    """
    if mu.device.type not in ("cuda", "cpu"):
        raise ValueError(f"kl_normal_std_fused runs on CUDA or the CPU, not {mu.device}")
    return _KLStd.apply(mu, scale)
