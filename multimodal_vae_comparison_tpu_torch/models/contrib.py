"""Contrib API: an example third-party mixing strategy (counterpart of
``models/contrib.py``).

The plugin pattern: subclass a model of the zoo, change what it mixes, and
register the class in ``models/__init__.py``'s ``MIXING_REGISTRY`` under a
new config name (``mixing: poe2``).
"""
from __future__ import annotations

from multimodal_vae_comparison_tpu_torch.models.mmvae import POE


class POE2(POE):
    """Example contrib model: PoE without the universal prior expert, in
    serving's one product and in the training lattice alike."""

    prior_expert = False
