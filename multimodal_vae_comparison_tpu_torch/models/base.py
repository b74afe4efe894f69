"""Multimodal VAE base (counterpart of ``models/base.py``).

The static modality spec, ``build_specs``, and the shared machinery of
every mixing strategy: encode/decode, the priors and posteriors, the KL
terms and the reconstruction log-likelihood.  Submodules carry flax's names
(``enc_mod_1``, ``dec_mod_2``, ``pz_logvar``, ``pz_mog_loc``) so that
``bridge.load_flax_params`` maps the reference's parameters one to one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodal_vae_comparison_tpu_torch.device import resolve_device
from multimodal_vae_comparison_tpu_torch.models import objectives
from multimodal_vae_comparison_tpu_torch.models.decoders import get_decoder
from multimodal_vae_comparison_tpu_torch.models.distributions import (
    MixtureNormal, Normal, get_dist, kl_divergence)
from multimodal_vae_comparison_tpu_torch.models.encoders import get_encoder
from multimodal_vae_comparison_tpu_torch.models.output import VAEOutput
from multimodal_vae_comparison_tpu_torch.models.precision import Linear, set_compute_dtype
from multimodal_vae_comparison_tpu_torch.parallel import rows
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


class _EndpointHead(nn.Module):
    """Dense 128, relu, Dense 3: the joint latents -> the predicted 3-D
    endpoint of the action trajectory (auxiliary latent supervision).  The
    last Dense computes in fp32 under any compute dtype, as the reference
    builds it."""

    def __init__(self, n_latents: int, hidden: int = 128):
        super().__init__()
        self.Dense_0 = Linear(n_latents, hidden)
        self.Dense_1 = Linear(hidden, 3)
        self.Dense_1.fp32_only = True

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(z)))


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

    ``prior_components = C > 1`` replaces the learned-scale Gaussian prior
    with a learnable mixture of C diagonal Gaussians (``pz_mog_loc`` ~ N(0,
    1), ``pz_mog_rawscale`` and ``pz_mog_logits`` zeros, as flax draws
    them), whose KL to a posterior is a Monte-Carlo mean over the drawn
    latents (:meth:`kld_to_prior`).

    ``aux_endpoint > 0`` adds ``aux_head``, the endpoint head that
    :meth:`aux_endpoint_loss` trains with that weight (POE's objective
    reads it), where there is an action-waypoint modality to supervise it.
    A modality with ``cond_on`` gets a decoder built for the conditioning
    modality's token width (``cond_features``).

    ``dtype`` is the nets' compute dtype (``models/precision.py``): bf16
    runs every layer in bf16 as the reference's ``dtype=bf16`` does, while
    the parameters, the priors, the posteriors and the losses' sums stay
    fp32.
    """

    def __init__(self, specs: Tuple[ModalitySpec, ...], n_latents: int,
                 K: int = 1, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 obj: str = "elbo", beta: float = 1.0,
                 prior_components: int = 1, remat: bool = False,
                 aux_endpoint: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if prior_components < 1:
            raise ValueError(f"prior_components must be >= 1, got {prior_components}")
        device = resolve_device(device)
        self.specs = tuple(specs)
        self.n_latents = n_latents
        self.K = K
        self.obj = obj
        self.beta = beta
        self.remat = remat
        self.prior_components = prior_components
        self.aux_endpoint = float(aux_endpoint)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            for spec in self.specs:
                self.add_module(f"enc_{spec.name}", get_encoder(spec.encoder)(
                    latent_dim=n_latents, data_dim=spec.feature_dims,
                    latent_private=spec.private_latents))
                extra = {}
                if spec.cond_on is not None:
                    extra["cond_features"] = math.prod(
                        int(d) for d in self.spec(spec.cond_on).feature_dims[1:])
                self.add_module(f"dec_{spec.name}", get_decoder(spec.decoder)(
                    latent_dim=n_latents, data_dim=spec.feature_dims,
                    latent_private=spec.private_latents, **extra))
            if prior_components > 1:
                # spread component means; raw scale 0 -> softplus(0.5413) ~ 1
                C = prior_components
                self.pz_mog_loc = nn.Parameter(torch.randn(C, n_latents))
                self.pz_mog_rawscale = nn.Parameter(torch.zeros(C, n_latents))
                self.pz_mog_logits = nn.Parameter(torch.zeros(C))
            if self.aux_endpoint > 0 and self.endpoint_spec():
                self.aux_head = _EndpointHead(n_latents)
        # learnable-scale prior: mu fixed 0, scale = softmax(raw) * D, raw
        # from zeros -> N(0, 1) at init
        self.pz_logvar = nn.Parameter(torch.zeros(1, n_latents))
        self.dtype = dtype
        set_compute_dtype(self, dtype)
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

    def pz(self):
        """The prior: the learned-scale Gaussian, (1, D), or with
        ``prior_components > 1`` the learnable mixture."""
        if self.prior_components > 1:
            scale = F.softplus(self.pz_mog_rawscale + 0.5413) + 1e-4
            return MixtureNormal(self.pz_mog_loc, scale, self.pz_mog_logits)
        return Normal(*self.pz_params())

    def sample_pz(self, num: int, temperature: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None,
                  idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(1, num, D) prior draws for joint generation.  The Gaussian's
        ``mu + temperature * scale * eps`` with ``eps`` (1, num, D); the
        mixture's :meth:`MixtureNormal.sample`, its component ``idx`` (num,)
        then ``eps`` (num, D).  Each is injected, or drawn from
        ``generator`` on its own device."""
        if self.prior_components > 1:
            return self.pz().sample(num, temperature, generator=generator, idx=idx,
                                    eps=eps)[None]
        mu, scale = self.pz_params()
        shape = (1, num, self.n_latents)
        if eps is None:
            eps = torch.randn(shape, generator=generator,
                              device=None if generator is None else generator.device)
        elif tuple(eps.shape) != shape:
            raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {shape}")
        return mu + temperature * scale * eps.to(mu.device, mu.dtype)

    def kld_to_prior(self, dist, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B,) KL(dist || learned prior): closed form for the Gaussian
        prior; for the mixture, which has none, the Monte-Carlo mean over
        the (K, B, D) latents ``z`` already drawn from ``dist``."""
        pz = self.pz()
        if isinstance(pz, Normal):
            return kl_divergence(dist, pz).sum(-1)
        if z is None:
            raise ValueError("the mixture prior's KL needs the drawn latents z")
        return (dist.log_prob(z).sum(-1) - pz.log_prob(z)).mean(0)

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
        of the KL kernel for each width among them (DMVAE's private
        posteriors may differ in width), any other family through
        :meth:`kld_std`."""
        by_shape: Dict[tuple, list] = {}
        for s in self.specs:
            d = dists[s.name]
            if isinstance(d, Normal) and s.prior in ("normal", "gaussian"):
                by_shape.setdefault(tuple(d.loc.shape), []).append(s.name)
        rows = {}
        for names in by_shape.values():
            fused = kl_normal_std_multi([dists[n].loc.contiguous() for n in names],
                                        [dists[n].scale.contiguous() for n in names])
            if len(names) == len(self.specs):
                return fused
            rows.update(zip(names, fused.unbind(0)))
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
                         generator: Optional[torch.Generator] = None,
                         K: Optional[int] = None):
        """(q(z|x), (K, B, D) reparameterized draw): ``eps`` injected, or
        drawn from ``generator``; ``K`` draws (default the model's)."""
        qz = self.posterior(spec, *params)
        return qz, qz.rsample((K or self.K,), generator=generator, eps=eps)

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

    def endpoint_spec(self) -> Optional[ModalitySpec]:
        """The action-waypoint modality the endpoint head is supervised on
        (waypoints are padded by repeating the last achieved position, so
        ``data[:, -1, :3]`` is the trajectory's endpoint)."""
        return next((s for s in self.specs if s.mod_type == "action_waypoints"), None)

    def aux_endpoint_loss(self, z: torch.Tensor, batch):
        """(weighted loss term, mean per-row squared error) of the endpoint
        head on the (K, B, D) latents ``z``: the squared error to the first
        3 features of the last waypoint, averaged over K, summed over B for
        the loss (times ``aux_endpoint``) and averaged for the metric."""
        spec = self.endpoint_spec()
        if spec is None:
            raise ValueError("aux_endpoint needs an action_waypoints modality")
        target = batch[spec.name]["data"][:, -1]
        target = target.reshape(target.shape[0], -1)[:, :3]          # (B, 3)
        pred = self.aux_head(z[..., : self.n_latents])               # (K, B, 3)
        per_sample = ((pred - target[None]) ** 2).sum(-1).mean(0)    # (B,)
        return self.aux_endpoint * per_sample.sum(), rows.row_mean(per_sample)

    def forward(self, batch, present: Tuple[str, ...], eps=None,
                generator=None) -> VAEOutput:
        raise NotImplementedError

    def objective(self, batch, eps=None, generator=None):
        """(loss, metrics) over one batch."""
        raise NotImplementedError
