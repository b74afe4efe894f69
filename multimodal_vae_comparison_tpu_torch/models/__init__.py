"""Model zoo registry: mixing strategies by the config's ``mixing`` string.

Only ``poe`` is ported so far.
"""
from multimodal_vae_comparison_tpu_torch.models.mmvae import POE

MIXING_REGISTRY = {
    "poe": POE,
}


def get_mixing(name: str):
    key = name.lower()
    if key not in MIXING_REGISTRY:
        raise KeyError(
            f"unknown mixing strategy '{name}'; available: {sorted(MIXING_REGISTRY)}")
    return MIXING_REGISTRY[key]
