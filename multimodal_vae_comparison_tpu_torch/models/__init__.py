"""Model zoo registry: mixing strategies by the config's ``mixing`` string.

POE (MVAE), MOE (MMVAE), MoPOE, DMVAE and the contrib POE2.  A config
with one modality builds ``mmvae.UnimodalVAE`` whatever its ``mixing``
(``training.trainer.build_model``), as the reference does.
"""
from multimodal_vae_comparison_tpu_torch.models.contrib import POE2
from multimodal_vae_comparison_tpu_torch.models.mmvae import DMVAE, MOE, POE, MoPOE

MIXING_REGISTRY = {
    "moe": MOE,
    "poe": POE,
    "mopoe": MoPOE,
    "dmvae": DMVAE,
    "poe2": POE2,
}


def get_mixing(name: str):
    key = name.lower()
    if key not in MIXING_REGISTRY:
        raise KeyError(
            f"unknown mixing strategy '{name}'; available: {sorted(MIXING_REGISTRY)}")
    return MIXING_REGISTRY[key]
