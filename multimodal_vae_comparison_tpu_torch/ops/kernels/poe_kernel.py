"""Product-of-experts precision fusion: CUDA kernel and its plain version.

Counterpart of ``ops/pallas/poe_kernel.py`` (``poe_fused``).  The kernel is
``csrc/poe.cu``; :func:`poe_reference` is the same function in plain
PyTorch.  :func:`poe_fused` is a ``torch.autograd.Function`` whose forward
launches the kernel for CUDA tensors and takes the plain version only for
CPU tensors; its backward is the closed form of the reference's
``_poe_bwd``, in torch ops.  ``prior_precision`` gets no gradient.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

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


class _PoE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mus, scales, prior_precision):
        if mus.is_cuda:
            telemetry.record(KERNEL, "cuda")
            mu, scale = _launch(mus, scales, prior_precision)
        else:
            telemetry.record(KERNEL, "plain")
            mu, scale = poe_reference(mus, scales, prior_precision)
        ctx.save_for_backward(mus, scales, mu, scale)
        return mu, scale

    @staticmethod
    @once_differentiable
    def backward(ctx, g_mu, g_scale):
        mus, scales, mu, scale = ctx.saved_tensors
        var = scales.square() + EPS
        prec = 1.0 / var                         # (E, ..., D)
        inv_denom = scale.square()               # 1 / (sum_e prec_e + p0)
        # d mu / d mu_e = prec_e * inv_denom
        d_mus = g_mu[None] * prec * inv_denom[None]
        # d mu / d prec_e = (mu_e - mu) * inv_denom;
        # d scale / d prec_e = -0.5 * inv_denom^(3/2)
        g_prec = (g_mu * inv_denom)[None] * (mus - mu[None]) \
            + (g_scale * (-0.5) * inv_denom * scale)[None]
        # d prec_e / d scale_e = -2 scale_e / var_e^2
        d_scales = g_prec * (-2.0 * scales / var.square())
        return d_mus, d_scales, None


def poe_fused(mus: torch.Tensor, scales: torch.Tensor,
              prior_precision: float = 1.0):
    """PoE fusion: CUDA kernel for CUDA tensors, plain version for CPU ones;
    gradients to ``mus`` and ``scales`` by the closed form.

    :param mus: (E, ..., D) expert means
    :param scales: (E, ..., D) expert stddevs
    :return: (mu, scale) of the product Gaussian, shape (..., D)
    """
    if mus.device.type not in ("cuda", "cpu"):
        raise ValueError(f"poe_fused runs on CUDA or the CPU, not {mus.device}")
    return _PoE.apply(mus, scales, float(prior_precision))
