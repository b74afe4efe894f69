"""Fused reparameterized Gaussian sampling: CUDA kernel and plain version.

Counterpart of ``ops/pallas/sample_kernel.py`` (``sample_normal_fused``):
``z = mu + scale * eps`` with ``eps`` drawn inside the kernel from an integer
seed, two uint32 draws per element turned into a standard normal by
Box-Muller.  The kernel is ``csrc/sample.cu``; :func:`sample_reference` is
the same function in plain PyTorch, with the same generator written in
integer tensor ops, so the two agree element by element.

The draws come from Philox4x32-10 keyed by the seed, with the element index
as the counter.  The stream differs by nature from the reference's, which
draws from the TPU core's own generator in the kernel and from threefry on
other backends; only the bits -> normal map (:func:`boxmuller_from_bits`),
the moments and the backward are the same.

:func:`sample_normal_fused` is a ``torch.autograd.Function``: the forward
launches the kernel for CUDA tensors and takes the plain version only for
CPU tensors, keeps ``eps``, and the backward is ``(g, g * eps)``.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from multimodal_vae_comparison_tpu_torch.ops.flops import kernel_flops
from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, telemetry

KERNEL = "sample"
TWO_PI = 2.0 * math.pi
_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
# sample_forward(mu, scale, z, eps, n, seed_lo, seed_hi, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_uint,
                                     ctypes.c_uint, ctypes.c_void_p]


def philox4x32_10(counter, key):
    """One Philox4x32-10 block: four uint32 counter words and two key words
    (ints or int64 tensors holding values below 2^32) -> four output words,
    as int64 tensors (or ints) below 2^32."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        # int64 products wrap modulo 2^64, which keeps every bit that is used
        p0, p1 = _PHILOX_M0 * c0, _PHILOX_M1 * c2
        c0, c1, c2, c3 = (((p1 >> 32) & _M32) ^ c1 ^ k0, p1 & _M32,
                          ((p0 >> 32) & _M32) ^ c3 ^ k1, p0 & _M32)
        k0, k1 = (k0 + _PHILOX_W0) & _M32, (k1 + _PHILOX_W1) & _M32
    return c0, c1, c2, c3


def random_bits(n: int, seed: int, device) -> tuple:
    """The two uint32 draws of elements 0..n-1 under ``seed``, as int64
    tensors: words 0 and 1 of the Philox block whose counter is the index."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    a, b, _, _ = philox4x32_10((idx & _M32, idx >> 32, zero, zero),
                               (seed & _M32, (seed >> 32) & _M32))
    return a, b


def boxmuller_from_bits(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """uint32 random bits (any integer dtype; a signed 32-bit pattern is read
    as unsigned) -> standard normals, as the reference's
    ``_boxmuller_from_bits``: the top 24 bits give u1 in (0, 1] and u2 in
    [0, 1), and eps = sqrt(-2 log u1) cos(2 pi u2)."""
    a24 = (bits_a.to(torch.int64) & _M32) >> 8
    b24 = (bits_b.to(torch.int64) & _M32) >> 8
    u1 = a24.to(torch.float32) * (1.0 / (1 << 24)) + 1e-7
    u2 = b24.to(torch.float32) * (1.0 / (1 << 24))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


def sample_reference(mu: torch.Tensor, scale: torch.Tensor, seed: int):
    """Plain PyTorch version: (z, eps), each of mu's shape."""
    eps = boxmuller_from_bits(*random_bits(mu.numel(), seed, mu.device))
    eps = eps.reshape(mu.shape)
    return mu + scale * eps, eps


def _launch(mu: torch.Tensor, scale: torch.Tensor, seed: int):
    if mu.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"sample kernel takes float32, got {mu.dtype}, {scale.dtype}")
    if mu.shape != scale.shape or mu.numel() == 0:
        raise ValueError(f"sample kernel takes equal non-empty shapes, got "
                         f"{tuple(mu.shape)} and {tuple(scale.shape)}")
    if mu.device != scale.device:
        raise ValueError("mu and scale lie on different devices")
    if not (mu.is_contiguous() and scale.is_contiguous()):
        raise ValueError("sample kernel takes contiguous tensors")
    fn = _build.function(KERNEL, "sample_forward", _ARGTYPES)
    z, eps = torch.empty_like(mu), torch.empty_like(mu)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    err = fn(mu.data_ptr(), scale.data_ptr(), z.data_ptr(), eps.data_ptr(),
             mu.numel(), seed & _M32, (seed >> 32) & _M32, stream)
    _build.check(KERNEL, err)
    telemetry.count_launch(KERNEL)
    return z, eps


class _SampleNormal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, scale, seed):
        with kernel_flops(0):   # no product: 0 FLOPs to ops.flops on either route
            if mu.is_cuda:
                telemetry.record(KERNEL, "cuda")
                z, eps = _launch(mu, scale, seed)
            else:
                telemetry.record(KERNEL, "plain")
                z, eps = sample_reference(mu, scale, seed)
        ctx.save_for_backward(eps)
        return z

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (eps,) = ctx.saved_tensors
        return g, g * eps, None


def sample_normal_fused(mu: torch.Tensor, scale: torch.Tensor, seed: int) -> torch.Tensor:
    """z ~ N(mu, scale) with the noise drawn inside the kernel; returns z.

    :param mu, scale: float32 tensors of one shape
    :param seed: integer in [0, 2^64); one seed gives one draw
    """
    if mu.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sample_normal_fused runs on CUDA or the CPU, not {mu.device}")
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must lie in [0, 2^64), got {seed}")
    return _SampleNormal.apply(mu, scale, seed)
