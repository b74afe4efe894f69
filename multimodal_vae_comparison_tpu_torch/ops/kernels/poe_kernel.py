"""Product-of-experts precision fusion: CUDA kernels and their plain versions.

Counterpart of ``ops/pallas/poe_kernel.py`` (``poe_fused`` and its
closed-form VJP ``_poe_bwd``).  The kernels are ``csrc/poe.cu``: one launch
fuses the experts of every subset of a lattice (:func:`poe_lattice`), one
launch gives every expert's gradient summed over the subsets that hold it.
:func:`poe_fused` is the one-subset case of the same kernels.  The plain
versions are :func:`poe_reference` (one subset), :func:`poe_lattice_reference`
(the subsets stacked) and :func:`poe_lattice_backward_reference` (the closed
form of ``_poe_bwd`` summed in lattice order); the autograd Function takes
them only for CPU tensors.  ``prior_precision`` gets no gradient.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from multimodal_vae_comparison_tpu_torch.constants import EPS
from multimodal_vae_comparison_tpu_torch.ops.kernels import _build, telemetry

KERNEL = "poe"
KERNEL_BWD = "poe_bwd"
MAX_EXPERTS = 8    # csrc/poe.cu MAX_EXPERTS
MAX_SUBSETS = 32   # csrc/poe.cu MAX_SUBSETS
# poe_lattice_forward(mus, scales, experts, masks, subsets, mu_out,
#                     scale_out, n, p0, stream)
_FWD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] \
    + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
# poe_lattice_backward(mus, scales, experts, masks, subsets, g_mu, g_scale,
#                      mu_out, scale_out, d_mus, d_scales, n, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int] \
    + [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p]


def poe_reference(mus: torch.Tensor, scales: torch.Tensor,
                  prior_precision: float = 1.0):
    """Plain PyTorch PoE fusion: (E, ..., D) experts -> (mu, scale) (..., D)."""
    precision = 1.0 / (scales.square() + EPS)
    denom = precision.sum(0) + prior_precision
    mu = (mus * precision).sum(0) / denom
    return mu, torch.sqrt(1.0 / denom)


def poe_lattice_reference(mus: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                          lattice: Sequence[Sequence[int]], prior_precision: float = 1.0):
    """Plain PyTorch PoE over a lattice: :func:`poe_reference` of each
    subset's experts (ascending), stacked -> (mu, scale) (S, ..., D)."""
    fused = [poe_reference(torch.stack([mus[e] for e in sorted(subset)]),
                           torch.stack([scales[e] for e in sorted(subset)]),
                           prior_precision)
             for subset in lattice]
    return torch.stack([f[0] for f in fused]), torch.stack([f[1] for f in fused])


def poe_lattice_backward_reference(mus, scales, mu, scale, g_mu, g_scale,
                                   lattice: Sequence[Sequence[int]]) -> Tuple[list, list]:
    """Plain PyTorch backward of :func:`poe_lattice`: the closed form of the
    reference's ``_poe_bwd`` per subset, each expert's terms summed over the
    subsets that hold it in lattice order (zeros where none does)."""
    var = [s.square() + EPS for s in scales]
    prec = [1.0 / v for v in var]
    dprec_dscale = [-2.0 * s / v.square() for s, v in zip(scales, var)]
    d_mus: List = [torch.zeros_like(m) for m in mus]
    d_scales: List = [torch.zeros_like(s) for s in scales]
    for k, subset in enumerate(lattice):
        inv = scale[k].square()                       # 1 / (sum prec + p0)
        gm_inv = g_mu[k] * inv
        gs_term = g_scale[k] * (-0.5) * inv * scale[k]
        for e in subset:
            d_mus[e] = d_mus[e] + g_mu[k] * prec[e] * inv
            d_scales[e] = d_scales[e] + (gm_inv * (mus[e] - mu[k]) + gs_term) * dprec_dscale[e]
    return d_mus, d_scales


def lattice_masks(lattice: Sequence[Sequence[int]], experts: int) -> Tuple[int, ...]:
    """Each subset as a bitmask over the experts; raises on what the
    kernels do not take (empty subsets, indices out of range, over
    MAX_EXPERTS experts or MAX_SUBSETS subsets)."""
    if not 1 <= experts <= MAX_EXPERTS:
        raise ValueError(f"poe kernels take 1 to {MAX_EXPERTS} experts, got {experts}")
    if not 1 <= len(lattice) <= MAX_SUBSETS:
        raise ValueError(f"poe kernels take 1 to {MAX_SUBSETS} subsets, got {len(lattice)}")
    masks = []
    for subset in lattice:
        if not subset or any(not 0 <= e < experts for e in subset) \
                or len(set(subset)) != len(subset):
            raise ValueError(f"subset {tuple(subset)} is not a non-empty set of "
                             f"expert indices below {experts}")
        masks.append(sum(1 << e for e in subset))
    return tuple(masks)


def _check(tensors: Sequence[torch.Tensor], what: str) -> None:
    first = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"poe kernels take float32 {what}, got {t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"poe kernels take {what} of one shape on one device, got "
                             f"{tuple(t.shape)} on {t.device} and {tuple(first.shape)} "
                             f"on {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"poe kernels take contiguous {what}")


def _pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _launch_forward(mus, scales, masks, prior_precision):
    _check(list(mus) + list(scales), "experts")
    fn = _build.function(KERNEL, "poe_lattice_forward", _FWD_ARGTYPES)
    shape = mus[0].shape
    mu = torch.empty((len(masks),) + shape, dtype=torch.float32, device=mus[0].device)
    scale = torch.empty_like(mu)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    err = fn(_pointers(mus), _pointers(scales), len(mus),
             (ctypes.c_uint * len(masks))(*masks), len(masks), mu.data_ptr(),
             scale.data_ptr(), mus[0].numel(), float(prior_precision), stream)
    _build.check(KERNEL, err)
    telemetry.count_launch(KERNEL)
    return mu, scale


def _launch_backward(mus, scales, masks, mu, scale, g_mu, g_scale):
    g_mu, g_scale = g_mu.contiguous(), g_scale.contiguous()
    _check([mu, scale, g_mu, g_scale], "outputs and their gradients")
    fn = _build.function(KERNEL, "poe_lattice_backward", _BWD_ARGTYPES)
    d_mus = torch.empty((len(mus),) + mus[0].shape, dtype=torch.float32,
                        device=mus[0].device)
    d_scales = torch.empty_like(d_mus)
    stream = torch.cuda.current_stream(mu.device).cuda_stream
    err = fn(_pointers(mus), _pointers(scales), len(mus),
             (ctypes.c_uint * len(masks))(*masks), len(masks), g_mu.data_ptr(),
             g_scale.data_ptr(), mu.data_ptr(), scale.data_ptr(), d_mus.data_ptr(),
             d_scales.data_ptr(), mus[0].numel(), stream)
    _build.check(KERNEL_BWD, err)
    telemetry.count_launch(KERNEL_BWD)
    return d_mus.unbind(0), d_scales.unbind(0)


class _PoELattice(torch.autograd.Function):
    """Inputs: the lattice (subsets of expert indices), p0, then the M expert
    means and the M expert stddevs; outputs (S, ..., D) mu and scale."""

    @staticmethod
    def forward(ctx, lattice, prior_precision, *experts):
        m = len(experts) // 2
        mus, scales = experts[:m], experts[m:]
        masks = lattice_masks(lattice, m)
        if mus[0].is_cuda:
            telemetry.record(KERNEL, "cuda")
            mu, scale = _launch_forward(mus, scales, masks, prior_precision)
        else:
            telemetry.record(KERNEL, "plain")
            mu, scale = poe_lattice_reference(mus, scales, lattice, prior_precision)
        ctx.lattice, ctx.masks = tuple(tuple(s) for s in lattice), masks
        ctx.save_for_backward(*experts, mu, scale)
        return mu, scale

    @staticmethod
    @once_differentiable
    def backward(ctx, g_mu, g_scale):
        *experts, mu, scale = ctx.saved_tensors
        m = len(experts) // 2
        mus, scales = experts[:m], experts[m:]
        if mu.is_cuda:
            telemetry.record(KERNEL_BWD, "cuda")
            d_mus, d_scales = _launch_backward(mus, scales, ctx.masks, mu, scale,
                                               g_mu, g_scale)
        else:
            telemetry.record(KERNEL_BWD, "plain")
            d_mus, d_scales = poe_lattice_backward_reference(
                mus, scales, mu, scale, g_mu, g_scale, ctx.lattice)
        return (None, None, *d_mus, *d_scales)


def _on_cuda_or_cpu(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on CUDA or the CPU, not {t.device}")


def poe_lattice(mus: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                lattice: Sequence[Sequence[int]], prior_precision: float = 1.0):
    """PoE fusion of every subset of a lattice in one launch: the CUDA
    kernel for CUDA tensors, the plain version for CPU ones; gradients to
    every expert in one launch of the backward kernel.

    :param mus: M expert means of one shape (..., D), or one (M, ..., D) tensor
    :param scales: M expert stddevs, as ``mus``
    :param lattice: S subsets, each a sequence of expert indices
    :param prior_precision: the N(0, 1) prior expert's precision, added once
        per subset; 0.0 leaves it out
    :return: (mu, scale), each (S, ..., D); row s is :func:`poe_fused` of
        subset s's experts
    """
    mus, scales = list(mus), list(scales)
    if len(mus) != len(scales) or not mus:
        raise ValueError(f"poe_lattice takes as many scales as means, got "
                         f"{len(mus)} and {len(scales)}")
    _on_cuda_or_cpu(mus[0], "poe_lattice")
    return _PoELattice.apply(tuple(tuple(s) for s in lattice), float(prior_precision),
                             *mus, *scales)


def poe_fused(mus: torch.Tensor, scales: torch.Tensor,
              prior_precision: float = 1.0):
    """PoE fusion of all E experts: the one-subset case of
    :func:`poe_lattice`.

    :param mus: (E, ..., D) expert means
    :param scales: (E, ..., D) expert stddevs
    :return: (mu, scale) of the product Gaussian, shape (..., D)
    """
    _on_cuda_or_cpu(mus, "poe_fused")
    if mus.shape != scales.shape or mus.dim() < 2:
        raise ValueError(f"poe_fused takes equal (E, ..., D) shapes, got "
                         f"{tuple(mus.shape)} and {tuple(scales.shape)}")
    mu, scale = poe_lattice(mus.unbind(0), scales.unbind(0),
                            (tuple(range(mus.shape[0])),), prior_precision)
    return mu[0], scale[0]
