"""Distributions (counterpart of ``models/distributions.py``).

Only the diagonal ``Normal`` that serving and the training slice need.
Like the reference it is a plain container of its parameters with
``log_prob``, ``kl`` and ``rsample``; ``rsample`` draws from an explicit
``torch.Generator`` or takes injected noise, so tests can feed both
packages the same draws.  Laplace, Bernoulli, OneHotCategorical and
MixtureNormal come with the slices whose models use them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from multimodal_vae_comparison_tpu_torch.constants import LOG2PI


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

    @property
    def variance(self) -> torch.Tensor:
        return self.scale.square()

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        var = self.scale.square()
        return -0.5 * ((x - self.loc).square() / var + 2.0 * torch.log(self.scale)
                       + LOG2PI)

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

    def kl(self, other: "Normal") -> torch.Tensor:
        """Closed-form KL(self || other) for diagonal Gaussians."""
        var_ratio = (self.scale / other.scale).square()
        t1 = ((self.loc - other.loc) / other.scale).square()
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


# the reference's DIST_MAP, restricted to the ported families
DIST_MAP = {
    "normal": Normal,
    "gaussian": Normal,
}


def get_dist(name: str):
    key = name.lower()
    if key not in DIST_MAP:
        raise KeyError(f"distribution '{name}' is not ported; available: "
                       f"{sorted(DIST_MAP)}")
    return DIST_MAP[key]


def log_prob_joint(dist, x: torch.Tensor) -> torch.Tensor:
    """Joint log-density over the event (last) axis; the ported families
    are factorized, so the per-dim terms are summed."""
    return dist.log_prob(x).sum(-1)


def kl_divergence(d1, d2) -> torch.Tensor:
    """Closed-form KL when both distributions share a family.  The
    reference's Monte-Carlo estimate between mixed families waits for a
    model that needs it."""
    if type(d1) is type(d2) and hasattr(d1, "kl"):
        return d1.kl(d2)
    raise NotImplementedError(
        f"KL between {type(d1).__name__} and {type(d2).__name__} needs the "
        "Monte-Carlo branch, which is not ported yet")


def log_mean_exp(value: torch.Tensor, dim: int = 0,
                 keepdim: bool = False) -> torch.Tensor:
    """log(mean(exp(value))) along ``dim``."""
    n = value.shape[dim]
    return torch.logsumexp(value, dim=dim, keepdim=keepdim) - math.log(n)
