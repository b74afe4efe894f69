"""The multimodal VAE zoo (counterpart of ``models/mmvae.py``).

Only POE's inference forward so far: the serving slice.  Its training
objective comes with the training slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodal_vae_comparison_tpu_torch.models.base import MMVAE
from multimodal_vae_comparison_tpu_torch.models.distributions import Normal
from multimodal_vae_comparison_tpu_torch.models.output import (
    ModalityOutput, VAEOutput)
from multimodal_vae_comparison_tpu_torch.ops.fusion import product_of_experts


def _mask_of(batch, name):
    return batch[name].get("masks")


class POE(MMVAE):
    """Product-of-experts MVAE: joint posterior = PoE(prior expert, present
    experts), one sample, decoded by every modality's decoder."""

    def _check_priors(self):
        for spec in self.specs:
            if spec.prior not in ("normal", "gaussian"):
                raise ValueError("POE only works with gaussian priors! "
                                 "Adjust the config")

    def mix(self, qz_params, present: Tuple[str, ...]):
        """PoE fusion of the present experts + analytic prior expert."""
        mus = torch.stack([qz_params[n]["shared"][0] for n in present])
        scales = torch.stack([qz_params[n]["shared"][1] for n in present])
        return product_of_experts(mus, scales, include_prior=True)

    def forward(self, batch, present: Tuple[str, ...],
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        """:param eps: optional injected (K, B, D) standard-normal draw for
            the joint sample; drawn from ``generator`` when absent"""
        self._check_priors()
        qz_params = self.encode(batch, present)
        mu, scale = self.mix(qz_params, present)
        joint = Normal(mu, scale)
        z = joint.rsample((self.K,), generator=generator, eps=eps)
        mods = {}
        for spec in self.specs:
            dec = self.decode_mod(spec.name, z, _mask_of(batch, spec.name),
                                  cond=self._cond_for(spec.name, batch, present))
            enc = (Normal(*qz_params[spec.name]["shared"])
                   if spec.name in present else None)
            mods[spec.name] = ModalityOutput(encoder_dist=enc, joint_dist=joint,
                                             decoder_dist=dec, latents=z)
        return VAEOutput(mods=mods)
