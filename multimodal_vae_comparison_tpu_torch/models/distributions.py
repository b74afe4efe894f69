"""Distributions (counterpart of ``models/distributions.py``).

The diagonal ``Normal`` and ``Laplace``, the ``OneHotCategorical`` of the
unimodal VAE's gumbel-softmax path, the ``Bernoulli`` of BCE likelihoods,
and the learnable mixture-of-Gaussians prior ``MixtureNormal``.  Like the reference each is a plain container of
its parameters with ``log_prob`` and a sampler; the samplers draw from an
explicit ``torch.Generator`` or take injected noise, so tests can feed both
packages the same draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from multimodal_vae_comparison_tpu_torch.constants import ETA, LOG2PI
from multimodal_vae_comparison_tpu_torch.parallel import rows


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
        drawn from ``generator`` unless given.  The draw is made on the
        generator's device and moved to ``loc``'s, so a CPU generator gives
        the card the CPU's draws."""
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        if eps is None:
            eps = rows.draw(shape, len(sample_shape),
                            lambda s: _draw(s, generator, self.loc))
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {shape}")
        return self.loc + eps * self.scale

    def kl(self, other: "Normal") -> torch.Tensor:
        """Closed-form KL(self || other) for diagonal Gaussians."""
        var_ratio = (self.scale / other.scale).square()
        t1 = ((self.loc - other.loc) / other.scale).square()
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


@dataclasses.dataclass(frozen=True)
class Laplace:
    loc: torch.Tensor
    scale: torch.Tensor

    # the open interval of the uniform draw of the inverse-CDF sampler
    U_LOW, U_HIGH = -0.5 + 1e-7, 0.5 - 1e-7

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return -(x - self.loc).abs() / self.scale - torch.log(2.0 * self.scale)

    def rsample(self, sample_shape: Sequence[int] = (),
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inverse-CDF sampling, ``loc - scale sign(u) log1p(-2 |u|)``, with
        ``u`` ~ U(U_LOW, U_HIGH) of shape ``sample_shape + loc.shape``:
        ``eps`` is that uniform draw when given, else it is drawn from
        ``generator`` on the generator's device and moved to ``loc``'s."""
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        if eps is None:
            r = rows.draw(shape, len(sample_shape), lambda s: torch.rand(
                s, generator=generator, dtype=self.loc.dtype,
                device=self.loc.device if generator is None else generator.device))
            eps = (self.U_LOW + (self.U_HIGH - self.U_LOW) * r).to(self.loc.device)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {shape}")
        return self.loc - self.scale * torch.sign(eps) * torch.log1p(-2.0 * eps.abs())

    def kl(self, other: "Laplace") -> torch.Tensor:
        """Closed-form KL(self || other) between Laplace distributions."""
        scale_ratio = self.scale / other.scale
        delta = (self.loc - other.loc).abs()
        return (scale_ratio * torch.exp(-delta / self.scale) + delta / other.scale - 1.0
                - torch.log(scale_ratio))


@dataclasses.dataclass(frozen=True)
class OneHotCategorical:
    """Categorical over the last axis, parameterized by ``logits``."""

    logits: torch.Tensor

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    def log_prob(self, x_onehot: torch.Tensor) -> torch.Tensor:
        return (x_onehot * torch.log_softmax(self.logits, dim=-1)).sum(-1)

    def rsample(self, sample_shape: Sequence[int] = (),
                generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None,
                temperature: float = 1.0) -> torch.Tensor:
        """Gumbel-softmax relaxed one-hot draw, ``softmax((logits + g) / T)``,
        with no straight-through estimator.  ``eps`` is the standard Gumbel
        noise ``g`` of shape ``sample_shape + logits.shape`` when given, else
        ``-log(-log(u))`` of a uniform ``u`` in [tiny, 1) drawn from
        ``generator`` on the generator's device and moved to the logits'."""
        shape = tuple(sample_shape) + tuple(self.logits.shape)
        if eps is None:
            dtype = self.logits.dtype
            u = rows.draw(shape, len(sample_shape), lambda s: torch.rand(
                s, generator=generator, dtype=dtype,
                device=self.logits.device if generator is None else generator.device))
            eps = (-torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))
                   ).to(self.logits.device)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {shape}")
        return torch.softmax((self.logits + eps) / temperature, dim=-1)

    def kl(self, other: "OneHotCategorical") -> torch.Tensor:
        """Closed-form KL(self || other) over the last axis."""
        logp = torch.log_softmax(self.logits, dim=-1)
        logq = torch.log_softmax(other.logits, dim=-1)
        return (torch.exp(logp) * (logp - logq)).sum(-1)


def stop_gradient(dist):
    """``dist`` of the same family with every tensor parameter detached."""
    return dataclasses.replace(dist, **{
        f.name: getattr(dist, f.name).detach() for f in dataclasses.fields(dist)
        if torch.is_tensor(getattr(dist, f.name))})


@dataclasses.dataclass(frozen=True)
class Bernoulli:
    """Bernoulli parameterized by probabilities (BCE likelihoods)."""

    probs: torch.Tensor

    @property
    def mean(self) -> torch.Tensor:
        return self.probs

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        p = torch.clamp(self.probs, ETA, 1.0 - ETA)
        return x * torch.log(p) + (1.0 - x) * torch.log1p(-p)


# the reference's DIST_MAP
DIST_MAP = {
    "normal": Normal,
    "gaussian": Normal,
    "laplace": Laplace,
    "categorical": OneHotCategorical,
    "bernoulli": Bernoulli,
    "gumbel": OneHotCategorical,   # the gumbel-softmax sampling path
}


def get_dist(name: str):
    key = name.lower()
    if key not in DIST_MAP:
        raise KeyError(f"unknown distribution '{name}'; available: {sorted(DIST_MAP)}")
    return DIST_MAP[key]


def _draw(shape, generator, like: torch.Tensor) -> torch.Tensor:
    """A standard-normal draw of ``shape`` made on the generator's device
    (the default one's when there is none) and moved to ``like``'s."""
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device if generator is None
                       else generator.device).to(like.device)


@dataclasses.dataclass(frozen=True)
class MixtureNormal:
    """Mixture of diagonal Gaussians, the learnable prior of
    ``prior_components > 1``: (C, D) ``locs`` and ``scales``, (C,)
    ``logits``.

    ``log_prob`` is the JOINT density over the last axis, (..., D) in,
    (...) out, unlike the factorized families' per-dim terms; use
    :func:`log_prob_joint` where both can come.
    """

    locs: torch.Tensor
    scales: torch.Tensor
    logits: torch.Tensor

    @property
    def mean(self) -> torch.Tensor:
        """(1, D): the mixture weights' average of the component means."""
        return (torch.softmax(self.logits, -1) @ self.locs)[None]

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        comp = Normal(self.locs, self.scales).log_prob(x[..., None, :]).sum(-1)
        return torch.logsumexp(comp + torch.log_softmax(self.logits, -1), dim=-1)

    def sample(self, num: int, temperature: float = 1.0,
               generator: Optional[torch.Generator] = None,
               idx: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(num, D) ancestral draws, ``locs[idx] + temperature * scales[idx]
        * eps``: the component ``idx`` (num,) drawn from the weights, then
        ``eps`` (num, D), each from ``generator`` unless given.  The
        component choice is not reparameterized (generation only)."""
        D = self.locs.shape[-1]
        if idx is None:
            probs = torch.softmax(self.logits.detach(), -1)
            if generator is not None:
                probs = probs.to(generator.device)
            idx = torch.multinomial(probs, num, replacement=True, generator=generator)
        if eps is None:
            eps = _draw((num, D), generator, self.locs)
        elif tuple(eps.shape) != (num, D):
            raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {(num, D)}")
        idx = torch.as_tensor(idx, device=self.locs.device).long()
        eps = eps.to(self.locs.device, self.locs.dtype)
        return self.locs[idx] + temperature * self.scales[idx] * eps


def log_prob_joint(dist, x: torch.Tensor) -> torch.Tensor:
    """Joint log-density over the event (last) axis for both conventions:
    the factorized families' per-dim terms are summed, a MixtureNormal's is
    already joint."""
    lp = dist.log_prob(x)
    return lp if isinstance(dist, MixtureNormal) else lp.sum(-1)


def kl_divergence(d1, d2, generator: Optional[torch.Generator] = None, n_mc: int = 100,
                  eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Closed-form KL when both distributions share a family, else the
    Monte-Carlo estimate ``mean(log q1(z) - log q2(z))`` over ``n_mc`` draws
    ``z`` of ``d1``, drawn from ``generator`` or made from the injected
    ``eps`` (the reference's ``kl_divergence``, which draws from a PRNG key
    and raises without one).  The mixture prior's KL is
    :meth:`MMVAE.kld_to_prior`'s."""
    if type(d1) is type(d2) and hasattr(d1, "kl"):
        return d1.kl(d2)
    if generator is None and eps is None:
        raise ValueError(f"the Monte-Carlo KL between {type(d1).__name__} and "
                         f"{type(d2).__name__} needs a generator or samples")
    samples = d1.rsample((n_mc,), generator=generator, eps=eps)
    return (d1.log_prob(samples) - d2.log_prob(samples)).mean(0)


def log_mean_exp(value: torch.Tensor, dim: int = 0,
                 keepdim: bool = False) -> torch.Tensor:
    """log(mean(exp(value))) along ``dim``."""
    n = value.shape[dim]
    return torch.logsumexp(value, dim=dim, keepdim=keepdim) - math.log(n)
