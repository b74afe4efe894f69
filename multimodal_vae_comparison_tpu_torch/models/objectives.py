"""Objectives (counterpart of ``models/objectives.py``).

The reconstruction-loss table and the ELBO / IWAE / DReG estimators as
functions over tensors.  ``recon_log_prob(ltype, dist, target, mask)``
returns per-batch-element log-likelihoods (higher is better).  DReG's
gradient re-weighting is :func:`scale_grad`, an identity whose backward
multiplies the incoming gradient by fixed importance weights (the
reference's ``jax.custom_vjp``).  ``feature_loss``, the perceptual loss
over a frozen VGG extractor, lives in ``models/perceptual.py``.
Each loss computes in the dtype of the decoder's output (bf16 under
``precision: bf16`` for the squashed image decoders) and sums in fp32 or
wider, as the reference does (``.sum(-1, dtype=jnp.float32)``).
:func:`check_ported` raises for a name the table lacks;
``build_model_from_config`` calls it for every modality of a config.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from multimodal_vae_comparison_tpu_torch.constants import ETA, LOG2PI
from multimodal_vae_comparison_tpu_torch.models.distributions import log_mean_exp
from multimodal_vae_comparison_tpu_torch.models.perceptual import feature_loss
from multimodal_vae_comparison_tpu_torch.models.precision import wide_dtype
from multimodal_vae_comparison_tpu_torch.parallel import rows


def _flatten_features(x: torch.Tensor, batch_ndims: int) -> torch.Tensor:
    return x.reshape(x.shape[:batch_ndims] + (-1,))


def _apply_mask(loss_elem: torch.Tensor, mask: Optional[torch.Tensor],
                batch_ndims: int) -> torch.Tensor:
    """Zero padded positions.  mask has shape (B, T); loss (..., B, T, feat...)."""
    if mask is None:
        return loss_elem
    m = mask.to(loss_elem.dtype)
    # broadcast the mask over leading K axes and trailing feature axes
    while m.dim() < loss_elem.dim():
        m = m[None] if m.dim() < batch_ndims + 1 else m[..., None]
    return loss_elem * m


def _sum_features(ll: torch.Tensor, mask, batch_ndims: int) -> torch.Tensor:
    ll = _apply_mask(ll, mask, batch_ndims)
    return _flatten_features(ll, batch_ndims).sum(-1, dtype=wide_dtype(ll.dtype))


# -- reconstruction losses (log-likelihood contributions; higher = better) --

def bce(dist, target, mask=None, batch_ndims=1):
    """Bernoulli log-likelihood of targets under ``dist.mean``.

    With the decoder's clipped logits (``dist.loc_logits``) the stable
    softplus form ``-(t softplus(-x) + (1-t) softplus(x))`` runs; without,
    the probability form over ``clip(p, eta, 1-eta)``."""
    x = getattr(dist, "loc_logits", None)
    if x is not None:
        t = target.to(x.dtype)
        ll = -(t * F.softplus(-x) + (1.0 - t) * F.softplus(x))
    else:
        p = torch.clamp(dist.mean, ETA, 1.0 - ETA)
        t = target.to(p.dtype)
        ll = t * torch.log(p) + (1.0 - t) * torch.log1p(-p)
    return _sum_features(ll, mask, batch_ndims)


def lprob(dist, target, mask=None, batch_ndims=1):
    """Exact log-probability of the targets under the likelihood
    distribution, a NaN term counted as 0."""
    ll = torch.nan_to_num(dist.log_prob(target), nan=0.0)
    return _sum_features(ll, mask, batch_ndims)


def l1(dist, target, mask=None, batch_ndims=1):
    ll = -(dist.mean - target.to(dist.mean.dtype)).abs()
    return _sum_features(ll, mask, batch_ndims)


def mse(dist, target, mask=None, batch_ndims=1):
    ll = -(dist.mean - target.to(dist.mean.dtype)).square()
    return _sum_features(ll, mask, batch_ndims)


def category_ce(dist, target, mask=None, batch_ndims=1):
    """Categorical cross-entropy over the trailing (alphabet) axis, with
    ``dist.mean`` taken as unnormalized scores."""
    logp = torch.log_softmax(dist.mean, dim=-1)
    ll = (target.to(logp.dtype) * logp).sum(-1, dtype=wide_dtype(logp.dtype))
    return _sum_features(ll, mask, batch_ndims)


def softclip(x: torch.Tensor, low: float) -> torch.Tensor:
    """Smoothly clamp ``x`` from below at ``low``."""
    return low + F.softplus(x - low)


def optimal_sigma(dist, target, mask=None, batch_ndims=1):
    """Gaussian log-likelihood with the analytic optimal sigma of the whole
    call (sigma-VAE): sigma^2 is the mean squared error over the valid
    positions only (padding does not count in the denominator), its log
    softclipped from below at -6; the gradient flows through sigma too.
    Under a data mesh the mean is the global batch's: the sum and the count
    are all-reduced over the data axis (``parallel/rows.py``)."""
    err2 = _apply_mask((target - dist.mean).square(), mask, batch_ndims)
    if mask is None and rows.current() is None:
        mean_err2 = err2.mean()
    else:
        valid = (err2.new_tensor(float(err2.numel())) if mask is None
                 else _apply_mask(torch.ones_like(err2), mask, batch_ndims).sum())
        mean_err2 = rows.global_sum(err2.sum()) / torch.clamp(rows.global_sum(valid),
                                                              min=1.0)
    log_sigma = softclip(0.5 * torch.log(mean_err2 + 1e-12), -6.0)
    ll = -(0.5 * err2 / torch.exp(2.0 * log_sigma) + log_sigma + 0.5 * LOG2PI)
    return _sum_features(ll, mask, batch_ndims)


RECON_LOSSES = {
    "bce": bce,
    "lprob": lprob,
    "l1": l1,
    "mse": mse,
    "category_ce": category_ce,
    "optimal_sigma": optimal_sigma,
    "feature_loss": feature_loss,
}


def check_ported(ltype: str) -> None:
    """Raise ``KeyError`` for a reconstruction loss the table lacks."""
    if ltype not in RECON_LOSSES:
        raise KeyError(f"recon loss '{ltype}' is not known; available: "
                       f"{sorted(RECON_LOSSES)}")


def recon_log_prob(ltype: str, dist, target, mask=None, batch_ndims=1):
    check_ported(ltype)
    return RECON_LOSSES[ltype](dist, target, mask, batch_ndims)


# -- DReG gradient re-weighting --------------------------------------------

class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g * w, None


def dreg_grad_weights(lw: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The stop-gradient importance weights that re-scale the latents'
    gradients: a softmax of the log-weights over the K axis ``dim``."""
    return torch.softmax(lw.detach(), dim=dim)


def scale_grad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Identity on ``x`` whose gradient is multiplied elementwise by ``w``
    (``w`` gets none)."""
    return _ScaleGrad.apply(x, w.detach())


# -- estimators --------------------------------------------------------------

def elbo(lpx_z: torch.Tensor, kld: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Negative ELBO, summed over the batch."""
    return -(lpx_z.sum() - beta * kld.sum())


def iwae(lw: torch.Tensor) -> torch.Tensor:
    """Negative IWAE bound from importance log-weights of shape (K, B)."""
    return -log_mean_exp(lw, dim=0).sum()


def dreg(lw: torch.Tensor) -> torch.Tensor:
    """DReG loss given (K, B) log-weights whose z-dependence went through
    :func:`scale_grad`; the weights are a softmax over K with no gradient."""
    return -(dreg_grad_weights(lw) * lw).mean(0).sum()
