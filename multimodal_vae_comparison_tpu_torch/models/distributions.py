"""Distributions (counterpart of ``models/distributions.py``).

Only the diagonal ``Normal`` that serving needs.  Like the reference it is
a plain container of its parameters; ``rsample`` draws from an explicit
``torch.Generator`` or takes injected noise, so tests can feed both
packages the same draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Normal:
    loc: torch.Tensor
    scale: torch.Tensor
    # optional pre-sigmoid logits of ``loc`` when it is a squashed image mean
    # (VaeDecoder.squash_dist)
    loc_logits: Optional[torch.Tensor] = None

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    def rsample(self, sample_shape: Sequence[int] = (),
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """loc + eps * scale with eps of shape ``sample_shape + loc.shape``,
        drawn from ``generator`` unless given."""
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        if eps is None:
            eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype,
                              device=self.loc.device)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {shape}")
        return self.loc + eps * self.scale
