"""Numeric constants shared across the port.

A copy of ``multimodal_vae_comparison_tpu/constants.py``: the port imports
nothing of the JAX package, so it keeps its own.
"""
import math

ETA = 1e-6        # variance / probability floor
EPS = 1e-8        # precision floor for product-of-experts
LOG2PI = math.log(2.0 * math.pi)
# Fixed decoder likelihood scale used by all image/sequence decoders.
DEC_SCALE = 0.75
# 27-symbol character alphabet used for text one-hot encoding.
ALPHABET = " abcdefghijklmnopqrstuvwxyz"
