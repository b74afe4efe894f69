"""Multimodal VAE base (counterpart of ``models/base.py``).

The static modality spec and the shared encode/decode machinery that the
serving slice runs.  Submodules carry flax's names (``enc_mod_1``,
``dec_mod_2``, ``pz_logvar``) so that ``bridge.load_flax_params`` maps the
reference's parameters one to one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from multimodal_vae_comparison_tpu_torch.device import resolve_device
from multimodal_vae_comparison_tpu_torch.models.decoders import get_decoder
from multimodal_vae_comparison_tpu_torch.models.distributions import Normal
from multimodal_vae_comparison_tpu_torch.models.encoders import get_encoder
from multimodal_vae_comparison_tpu_torch.models.output import VAEOutput


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


class MMVAE(nn.Module):
    """Base multimodal VAE.  Subclasses implement ``forward``, which takes
    the tuple ``present`` of modality names with data available.

    Parameters are drawn on the CPU from ``seed`` (PyTorch's default
    initializers under a forked RNG) and then moved to ``device``, so two
    instances built with one seed hold the same weights on any device.
    ``device`` defaults to CUDA and raises when there is none.
    """

    def __init__(self, specs: Tuple[ModalitySpec, ...], n_latents: int,
                 K: int = 1, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__()
        device = resolve_device(device)
        self.specs = tuple(specs)
        self.n_latents = n_latents
        self.K = K
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

    # -- shared machinery ------------------------------------------------------

    def encode(self, batch: Dict[str, Dict[str, Any]],
               present: Tuple[str, ...]):
        """Encode present modalities; split shared/private if factorized."""
        out = {}
        for spec in self.specs:
            if spec.name not in present:
                out[spec.name] = {"shared": None, "private": None}
                continue
            mod = batch[spec.name]
            mu, scale = self.encoders[spec.name](mod["data"], mod.get("masks"))
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
            out = self.decoders[name](z_flat, mask_rep, cond=cdata, cond_mask=cmask)
        else:
            out = self.decoders[name](z_flat, mask_rep)
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
