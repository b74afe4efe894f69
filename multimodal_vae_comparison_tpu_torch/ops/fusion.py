"""Posterior fusion primitives (counterpart of ``ops/fusion.py``).

The PoE fusion of one set of experts (:func:`product_of_experts`) and of
every subset of a lattice in one launch (:func:`poe_lattice`, from
``ops/kernels/poe_kernel.py``), and the subset lattice.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import torch

from multimodal_vae_comparison_tpu_torch.ops.kernels.poe_kernel import (
    poe_fused, poe_lattice, poe_reference)


def poe_precision_fusion(mus: torch.Tensor, scales: torch.Tensor,
                         prior_precision: float = 1.0):
    """Product of diagonal-Gaussian experts via precision weighting.

    :param mus: stacked expert means, shape (E, ..., D)
    :param scales: stacked expert stddevs, shape (E, ..., D)
    :param prior_precision: precision of the N(0, 1/sqrt(p)) prior expert
        folded in analytically; 0.0 disables it
    :return: (mu, scale) of the product Gaussian, shape (..., D)
    """
    return poe_reference(mus, scales, prior_precision)


def product_of_experts(mus: torch.Tensor, scales: torch.Tensor,
                       include_prior: bool = True):
    """PoE joint posterior from stacked experts; the CUDA kernel
    (``ops/kernels/poe_kernel.py``) for CUDA tensors."""
    return poe_fused(mus, scales, 1.0 if include_prior else 0.0)


def subset_lattice(num_mods: int,
                   forbidden: Sequence[Tuple[int, ...]] = ()) -> List[Tuple[int, ...]]:
    """All non-empty subsets of modality indices, smallest first."""
    idx = range(num_mods)
    subsets = []
    for n in range(1, num_mods + 1):
        subsets.extend(itertools.combinations(idx, n))
    forbidden = {tuple(sorted(f)) for f in forbidden}
    return [s for s in subsets if s not in forbidden]
