"""Multimodal VAE base (counterpart of ``models/base.py``).

The static modality spec, ``build_specs``, and the shared machinery of
every mixing strategy: encode/decode, the priors and posteriors, the KL
terms and the reconstruction log-likelihood.  Submodules carry flax's names
(``enc_mod_1``, ``dec_mod_2``, ``pz_logvar``) so that
``bridge.load_flax_params`` maps the reference's parameters one to one.
The mixture prior (``prior_components > 1``) and the aux endpoint head are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodal_vae_comparison_tpu_torch.device import resolve_device
from multimodal_vae_comparison_tpu_torch.models import objectives
from multimodal_vae_comparison_tpu_torch.models.decoders import get_decoder
from multimodal_vae_comparison_tpu_torch.models.distributions import (
    Normal, get_dist, kl_divergence)
from multimodal_vae_comparison_tpu_torch.models.encoders import get_encoder
from multimodal_vae_comparison_tpu_torch.models.output import VAEOutput
from multimodal_vae_comparison_tpu_torch.ops.kernels.kl_kernel import (
    kl_normal_std_fused, kl_normal_std_multi)


@dataclasses.dataclass(frozen=True)
class ModalitySpec:
    """Static description of one modality (from a ``modality_n`` config block)."""

    name: str                      # "mod_1", ...
    encoder: str                   # encoder class suffix, e.g. "CNN2"
    decoder: str
    feature_dims: Tuple[int, ...]  # dataset feature dims, e.g. (64, 64, 3)
    mod_type: str = "image"
    recon_loss: str = "bce"
    prior: str = "normal"
    llik_scaling: float = 1.0
    private_latents: Optional[int] = None
    has_masks: bool = False
    # modality whose raw data conditions this modality's decoder (None: the
    # decoder sees only z), and whether it does so on every subset
    cond_on: Optional[str] = None
    cond_always: bool = False


def build_specs(cfg) -> Tuple[ModalitySpec, ...]:
    """ModalitySpec tuple from a config object with ``.mods`` (one entry per
    ``modality_n`` block), resolving ``llik_scaling: auto`` to
    min(data dim) / this modality's data dim."""
    dims = [math.prod(int(d) for d in m.feature_dims) for m in cfg.mods]
    min_dim = min(dims)
    # cond_on names a modality block ("mod_2") or a mod_type ("language")
    by_type = {m.mod_type: m.name for m in cfg.mods}
    names = {m.name for m in cfg.mods}
    specs = []
    for m, d in zip(cfg.mods, dims):
        scaling = float(min_dim) / d if m.llik_scaling == "auto" else float(m.llik_scaling)
        cond = getattr(m, "cond_on", None)
        if cond is not None:
            cond = cond if cond in names else by_type.get(cond)
            if cond is None or cond == m.name:
                raise ValueError(f"cond_on of {m.name} must name another modality "
                                 f"(by mod_type or mod_n), got {m.cond_on}")
        specs.append(ModalitySpec(
            name=m.name, encoder=m.encoder, decoder=m.decoder,
            feature_dims=tuple(m.feature_dims), mod_type=m.mod_type,
            recon_loss=m.recon_loss, prior=m.prior, llik_scaling=scaling,
            private_latents=m.private_latents,
            has_masks=m.mod_type in ("text", "language", "actions", "sequence"),
            cond_on=cond, cond_always=bool(getattr(m, "cond_always", False))))
    return tuple(specs)


class MMVAE(nn.Module):
    """Base multimodal VAE.  Subclasses implement ``forward``, which takes
    the tuple ``present`` of modality names with data available, and
    ``objective``, the training loss over one batch.

    Parameters are drawn on the CPU from ``seed`` (PyTorch's default
    initializers under a forked RNG) and then moved to ``device``, so two
    instances built with one seed hold the same weights on any device.
    ``device`` defaults to CUDA and raises when there is none.

    With ``remat`` every encoder and decoder call is checkpointed while
    gradients are on: its activations are dropped after the forward and
    recomputed in the backward pass, trading operations for memory on the
    large video trunks.
    """

    def __init__(self, specs: Tuple[ModalitySpec, ...], n_latents: int,
                 K: int = 1, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 obj: str = "elbo", beta: float = 1.0,
                 prior_components: int = 1, remat: bool = False):
        super().__init__()
        if prior_components != 1:
            raise NotImplementedError(
                "the mixture-of-Gaussians prior (prior_components > 1) is not "
                "ported yet (ROADMAP Queue A item 2)")
        device = resolve_device(device)
        self.specs = tuple(specs)
        self.n_latents = n_latents
        self.K = K
        self.obj = obj
        self.beta = beta
        self.remat = remat
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            for spec in self.specs:
                self.add_module(f"enc_{spec.name}", get_encoder(spec.encoder)(
                    latent_dim=n_latents, data_dim=spec.feature_dims,
                    latent_private=spec.private_latents))
                self.add_module(f"dec_{spec.name}", get_decoder(spec.decoder)(
                    latent_dim=n_latents, data_dim=spec.feature_dims,
                    latent_private=spec.private_latents))
        # learnable-scale prior: mu fixed 0, scale = softmax(raw) * D, raw
        # from zeros -> N(0, 1) at init
        self.pz_logvar = nn.Parameter(torch.zeros(1, n_latents))
        self.to(device)

    # -- spec helpers --------------------------------------------------------

    @property
    def mod_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.specs)

    def spec(self, name: str) -> ModalitySpec:
        return next(s for s in self.specs if s.name == name)

    @property
    def encoders(self) -> Dict[str, nn.Module]:
        return {s.name: getattr(self, f"enc_{s.name}") for s in self.specs}

    @property
    def decoders(self) -> Dict[str, nn.Module]:
        return {s.name: getattr(self, f"dec_{s.name}") for s in self.specs}

    @property
    def device(self) -> torch.device:
        return self.pz_logvar.device

    # -- distributions --------------------------------------------------------

    def pz_params(self):
        scale = torch.softmax(self.pz_logvar, dim=1) * self.pz_logvar.shape[-1]
        return torch.zeros_like(self.pz_logvar), scale

    def pz(self) -> Normal:
        """The learned-scale Gaussian prior, (1, D)."""
        return Normal(*self.pz_params())

    def sample_pz(self, num: int, temperature: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(1, num, D) draws of the learned-scale Gaussian prior for joint
        generation, ``mu + temperature * scale * eps``; ``eps`` (1, num, D)
        injected, or drawn from ``generator`` on its own device."""
        mu, scale = self.pz_params()
        shape = (1, num, self.n_latents)
        if eps is None:
            eps = torch.randn(shape, generator=generator,
                              device=None if generator is None else generator.device)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {shape}")
        return mu + temperature * scale * eps.to(mu.device, mu.dtype)

    def kld_to_prior(self, dist) -> torch.Tensor:
        """(B,) KL(dist || learned prior), closed form (the mixture prior's
        Monte-Carlo estimate over drawn samples is not ported)."""
        return kl_divergence(dist, self.pz()).sum(-1)

    def posterior(self, spec: ModalitySpec, mu, scale):
        return get_dist(spec.prior)(mu, scale)

    def prior_for(self, spec: ModalitySpec, dim: Optional[int] = None):
        dim = dim or self.n_latents
        return get_dist(spec.prior)(torch.zeros(1, dim, device=self.device),
                                    torch.ones(1, dim, device=self.device))

    def kld_std(self, spec: ModalitySpec, dist) -> torch.Tensor:
        """Sum-over-latents KL(dist || unit prior of spec's family): the KL
        kernel (``ops/kernels/kl_kernel.py``) for the Gaussian family."""
        if isinstance(dist, Normal) and spec.prior in ("normal", "gaussian"):
            return kl_normal_std_fused(dist.loc.contiguous(), dist.scale.contiguous())
        return kl_divergence(dist, self.prior_for(spec, dim=dist.loc.shape[-1])).sum(-1)

    def kld_std_all(self, dists: Dict[str, Any]) -> torch.Tensor:
        """(M, ...) :meth:`kld_std` of every modality's posterior, in spec
        order: the Gaussian ones under a Gaussian prior through one launch
        of the KL kernel, any other family through :meth:`kld_std`."""
        gauss = [s.name for s in self.specs
                 if isinstance(dists[s.name], Normal) and s.prior in ("normal", "gaussian")]
        rows = {}
        if gauss:
            fused = kl_normal_std_multi([dists[n].loc.contiguous() for n in gauss],
                                        [dists[n].scale.contiguous() for n in gauss])
            if len(gauss) == len(self.specs):
                return fused
            rows = dict(zip(gauss, fused.unbind(0)))
        return torch.stack([rows[s.name] if s.name in rows else self.kld_std(s, dists[s.name])
                            for s in self.specs])

    def recon_lpx(self, spec: ModalitySpec, dist, batch) -> torch.Tensor:
        """Scaled per-(K, B) reconstruction log-likelihood of one modality."""
        target = batch[spec.name]["data"]
        mask = batch[spec.name].get("masks")
        lpx = objectives.recon_log_prob(spec.recon_loss, dist, target, mask,
                                        batch_ndims=dist.mean.dim() - target.dim() + 1)
        return lpx * spec.llik_scaling

    def sample_posterior(self, spec: ModalitySpec, params, eps=None,
                         generator: Optional[torch.Generator] = None):
        """(q(z|x), (K, B, D) reparameterized draw): ``eps`` injected, or
        drawn from ``generator``."""
        qz = self.posterior(spec, *params)
        return qz, qz.rsample((self.K,), generator=generator, eps=eps)

    # -- shared machinery ------------------------------------------------------

    def _run_net(self, net: nn.Module, *args, **kwargs):
        """Call an encoder or decoder, checkpointed under ``remat``.  The
        nets draw no random numbers, so no generator state is kept."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(net, *args, use_reentrant=False,
                              preserve_rng_state=False, **kwargs)
        return net(*args, **kwargs)

    def encode(self, batch: Dict[str, Dict[str, Any]],
               present: Tuple[str, ...]):
        """Encode present modalities; split shared/private if factorized."""
        out = {}
        for spec in self.specs:
            if spec.name not in present:
                out[spec.name] = {"shared": None, "private": None}
                continue
            mod = batch[spec.name]
            mu, scale = self._run_net(self.encoders[spec.name], mod["data"],
                                      mod.get("masks"))
            if spec.private_latents is None:
                out[spec.name] = {"shared": (mu, scale), "private": None}
            else:
                n = self.n_latents
                out[spec.name] = {
                    "shared": (mu[:, :n], scale[:, :n]),
                    "private": (mu[:, n:], scale[:, n:]),
                }
        return out

    def _cond_for(self, name: str, batch, present: Tuple[str, ...]):
        """(data, mask) of the conditioning modality for ``name``'s decoder,
        or None when unconditioned or the conditioning modality is absent
        (unless the spec sets ``cond_always``)."""
        spec = self.spec(name)
        if spec.cond_on is None:
            return None
        if not (spec.cond_always or spec.cond_on in present):
            return None
        mod = batch.get(spec.cond_on)
        if mod is None or mod.get("data") is None:
            return None
        return (mod["data"], mod.get("masks"))

    def decode_mod(self, name: str, z: torch.Tensor, mask=None, cond=None):
        """Decode (K, B, D) samples with modality ``name``'s decoder.

        K folds into the batch axis batch-major (row b*K + k), as in the
        reference, and unfolds after.  Shared-only latents are padded with
        zeros (the private prior's mean) for factorized decoders; any other
        width raises."""
        expected = self.n_latents + (self.spec(name).private_latents or 0)
        if z.shape[-1] != expected:
            if z.shape[-1] != self.n_latents:
                raise ValueError(
                    f"decode_mod('{name}') got latents of width "
                    f"{z.shape[-1]}; expected {expected} "
                    f"(or {self.n_latents} shared-only)")
            pad = z.new_zeros(z.shape[:-1] + (expected - z.shape[-1],))
            z = torch.cat([z, pad], dim=-1)
        K, B = z.shape[0], z.shape[1]
        z_flat = z.transpose(0, 1).reshape(B * K, z.shape[-1])
        mask_rep = None if mask is None else mask.repeat_interleave(K, dim=0)
        if cond is not None:
            cdata, cmask = cond
            cdata = cdata.repeat_interleave(K, dim=0)
            if cmask is not None:
                cmask = cmask.repeat_interleave(K, dim=0)
            out = self._run_net(self.decoders[name], z_flat, mask_rep, cond=cdata,
                                cond_mask=cmask)
        else:
            out = self._run_net(self.decoders[name], z_flat, mask_rep)
        # image decoders return (mean, scale, logits)
        mean, scale = out[0], out[1]
        logits = out[2] if len(out) > 2 else None
        mean = mean.reshape((B, K) + mean.shape[1:]).transpose(0, 1)
        if logits is not None:
            logits = logits.reshape((B, K) + logits.shape[1:]).transpose(0, 1)
        return Normal(mean, scale, loc_logits=logits)

    def forward(self, batch, present: Tuple[str, ...], eps=None,
                generator=None) -> VAEOutput:
        raise NotImplementedError

    def objective(self, batch, eps=None, generator=None):
        """(loss, metrics) over one batch."""
        raise NotImplementedError
