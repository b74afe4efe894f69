"""KL(N(mu, scale) || N(0, 1)) over the latents: CUDA kernels and plain versions.

Counterpart of ``ops/pallas/kl_kernel.py`` (``kl_normal_std_fused`` and its
closed-form VJP ``_kl_bwd``).  The kernels are ``csrc/kl.cu``: one launch
gives the KL of M posteriors at once (:func:`kl_normal_std_multi`), one
launch all M posteriors' gradients.  :func:`kl_normal_std_fused` is the
M = 1 case of the same kernels.  The plain versions are :func:`kl_reference`
(one posterior) and :func:`kl_multi_reference` (the posteriors stacked),
with the backward's closed form in torch ops; the autograd Function takes
them only for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, telemetry

KERNEL = "kl"
KERNEL_BWD = "kl_bwd"
MAX_POSTERIORS = 8   # csrc/kl.cu MAX_POSTERIORS
# kl_multi_forward(mus, scales, m, out, rows, d, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_void_p]
# kl_multi_backward(mus, scales, m, g, g_stride_m, g_stride_r, d_mu, d_scale,
#                   rows, d, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p] \
    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2 \
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def kl_reference(mu: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch sum_D KL(N(mu, scale) || N(0, 1)): (..., D) -> (...)."""
    var = scale.square()
    return (0.5 * (var + mu.square() - 1.0 - torch.log(var))).sum(-1)


def kl_multi_reference(mus: Sequence[torch.Tensor],
                       scales: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch KL of M posteriors: :func:`kl_reference` of each,
    stacked -> (M, ...)."""
    return torch.stack([kl_reference(m, s) for m, s in zip(mus, scales)])


def _check(mus, scales) -> None:
    first = mus[0]
    if not 1 <= len(mus) <= MAX_POSTERIORS:
        raise ValueError(f"kl kernels take 1 to {MAX_POSTERIORS} posteriors, got {len(mus)}")
    for t in list(mus) + list(scales):
        if t.dtype != torch.float32:
            raise TypeError(f"kl kernels take float32, got {t.dtype}")
        if t.shape != first.shape or t.dim() < 1 or t.numel() == 0:
            raise ValueError(f"kl kernels take equal non-empty (..., D) shapes, got "
                             f"{tuple(t.shape)} and {tuple(first.shape)}")
        if t.device != first.device:
            raise ValueError("kl kernels take posteriors on one device")
        if not t.is_contiguous():
            raise ValueError("kl kernels take contiguous tensors")


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch_forward(mus, scales, out_shape) -> torch.Tensor:
    _check(mus, scales)
    d = mus[0].shape[-1]
    fn = _build.function(KERNEL, "kl_multi_forward", _FWD_ARGTYPES)
    out = torch.empty(out_shape, dtype=torch.float32, device=mus[0].device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = fn(_pointers(mus), _pointers(scales), len(mus), out.data_ptr(),
             mus[0].numel() // d, d, stream)
    _build.check(KERNEL, err)
    telemetry.count_launch(KERNEL)
    return out


def _launch_backward(mus, scales, g):
    d = mus[0].shape[-1]
    rows = mus[0].numel() // d
    # (M, rows) with the upstream gradient's own strides: the broadcast
    # gradient of a sum stays a stride-0 view
    g = g.reshape(len(mus), rows)
    fn = _build.function(KERNEL, "kl_multi_backward", _BWD_ARGTYPES)
    d_mu = torch.empty((len(mus),) + mus[0].shape, dtype=torch.float32,
                       device=mus[0].device)
    d_scale = torch.empty_like(d_mu)
    stream = torch.cuda.current_stream(d_mu.device).cuda_stream
    err = fn(_pointers(mus), _pointers(scales), len(mus), g.data_ptr(), g.stride(0),
             g.stride(1), d_mu.data_ptr(), d_scale.data_ptr(), rows, d, stream)
    _build.check(KERNEL_BWD, err)
    telemetry.count_launch(KERNEL_BWD)
    return d_mu.unbind(0), d_scale.unbind(0)


class _KLStdMulti(torch.autograd.Function):
    """Inputs: ``stacked`` (False: one posterior, output (...) as
    :func:`kl_reference`'s), then the M means and the M stddevs; output
    (M, ...) where ``stacked``."""

    @staticmethod
    def forward(ctx, stacked, *posteriors):
        m = len(posteriors) // 2
        mus, scales = posteriors[:m], posteriors[m:]
        ctx.save_for_backward(*posteriors)
        out_shape = ((m,) if stacked else ()) + tuple(mus[0].shape[:-1])
        if mus[0].is_cuda:
            telemetry.record(KERNEL, "cuda")
            return _launch_forward(mus, scales, out_shape)
        telemetry.record(KERNEL, "plain")
        return kl_multi_reference(mus, scales).reshape(out_shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        posteriors = ctx.saved_tensors
        m = len(posteriors) // 2
        mus, scales = posteriors[:m], posteriors[m:]
        if mus[0].is_cuda:
            telemetry.record(KERNEL_BWD, "cuda")
            d_mus, d_scales = _launch_backward(mus, scales, g)
        else:
            telemetry.record(KERNEL_BWD, "plain")
            g = g.reshape((m,) + tuple(mus[0].shape[:-1]))[..., None]
            d_mus = [g[k] * mu for k, mu in enumerate(mus)]
            d_scales = [g[k] * (s - 1.0 / s) for k, s in enumerate(scales)]
        return (None, *d_mus, *d_scales)


def _on_cuda_or_cpu(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on CUDA or the CPU, not {t.device}")


def kl_normal_std_multi(mus: Sequence[torch.Tensor],
                        scales: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum_D KL(N(mu_m, scale_m) || N(0, 1)) for M posteriors in one launch:
    the CUDA kernel for CUDA tensors, the plain version for CPU ones;
    gradients to all of them in one launch of the backward kernel.

    :param mus, scales: M float32 tensors of one shape (..., D), or one
        (M, ..., D) tensor each
    :return: (M, ...) float32
    """
    mus, scales = list(mus), list(scales)
    if len(mus) != len(scales) or not mus:
        raise ValueError(f"kl_normal_std_multi takes as many scales as means, got "
                         f"{len(mus)} and {len(scales)}")
    _on_cuda_or_cpu(mus[0], "kl_normal_std_multi")
    return _KLStdMulti.apply(True, *mus, *scales)


def kl_normal_std_fused(mu: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """sum_D KL(N(mu, scale) || N(0, 1)): the M = 1 case of
    :func:`kl_normal_std_multi`.

    :param mu, scale: (..., D) float32
    :return: (...) float32
    """
    _on_cuda_or_cpu(mu, "kl_normal_std_fused")
    return _KLStdMulti.apply(False, mu, scale)
