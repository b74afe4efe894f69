"""Posterior fusion primitives (counterpart of ``ops/fusion.py``).

The PoE fusion of one set of experts (:func:`product_of_experts`) and of
every subset of a lattice in one launch (:func:`poe_lattice`, from
``ops/kernels/poe_kernel.py``), MoPoE's stratified mixture selection
(:func:`mixture_component_selection`), and the subset lattice.
"""
from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import torch

from multimodal_vae_comparison_tpu_torch.ops.kernels.poe_kernel import (
    poe_fused, poe_lattice, poe_reference)
from multimodal_vae_comparison_tpu_torch.parallel import rows


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
    (``ops/kernels/poe_kernel.py``) for CUDA tensors, where the prior
    expert is the one subset's prior bit."""
    return poe_fused(mus, scales, 1.0, prior_mask=None if include_prior else 0)


def mixture_splits(num_components: int, num_samples: int) -> List[Tuple[int, int]]:
    """The rows [start, end) of the batch that each of S uniformly weighted
    mixture components takes: ``int(B * w)`` rows each, in order, with the
    weight ``w = (1 / S) / sum of the S weights`` in Python floats as the
    reference computes it, and the last one the remainder (B 24 over 3
    gives 8/8/8, B 64 gives 21/21/22)."""
    weights = [1.0 / num_components] * num_components
    total = float(sum(weights))
    splits, start = [], 0
    for k in range(num_components):
        end = (num_samples if k == num_components - 1
               else start + int(num_samples * (weights[k] / total)))
        splits.append((start, end))
        start = end
    return splits


def mixture_component_selection(mus: torch.Tensor, scales: torch.Tensor):
    """MoPoE's stratified draw from a uniform mixture of S components: the
    batch is split across the components by :func:`mixture_splits` and each
    row takes its component's parameters (under a data mesh the global
    batch's split, ``parallel/rows.py``).

    :param mus: (S, B, D) component means
    :param scales: (S, B, D) component stddevs
    :return: (B, D) selected means and stddevs
    """
    n = mus.shape[1]
    shard = rows.current()
    start, total = (0, n) if shard is None else (shard.start, shard.total)
    # the global split, kept where it meets this rank's rows
    splits = [(max(a - start, 0), min(b - start, n))
              for a, b in mixture_splits(mus.shape[0], total)]
    return (torch.cat([mus[k, a:b] for k, (a, b) in enumerate(splits) if a < b], dim=0),
            torch.cat([scales[k, a:b] for k, (a, b) in enumerate(splits) if a < b], dim=0))


def subset_lattice(num_mods: int,
                   forbidden: Sequence[Tuple[int, ...]] = ()) -> List[Tuple[int, ...]]:
    """All non-empty subsets of modality indices, smallest first."""
    idx = range(num_mods)
    subsets = []
    for n in range(1, num_mods + 1):
        subsets.extend(itertools.combinations(idx, n))
    forbidden = {tuple(sorted(f)) for f in forbidden}
    return [s for s in subsets if s not in forbidden]
