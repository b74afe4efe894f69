"""The 8x8 hand-written digits that the MNIST-SVHN and PolyMNIST surrogate
builders draw their glyphs from.

``digits_8x8.npz`` beside this module is a copy of the digits bundled with
scikit-learn (``sklearn.datasets.load_digits``): the test set of the UCI
"Optical Recognition of Handwritten Digits" data, 1,797 images of 8x8
pixels with values 0..16 and their labels 0..9.  It was written once from
``load_digits`` and is stored as uint8 (``images`` (1797, 8, 8), ``target``
(1797,)); :func:`load_digits` gives back sklearn's arrays, float64 images
and int64 targets, byte for byte, without importing sklearn.
"""
from __future__ import annotations

import os
import types

import numpy as np

DIGITS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "digits_8x8.npz")


def load_digits() -> types.SimpleNamespace:
    """The digits as ``load_digits()`` gives them: ``.images`` (1797, 8, 8)
    float64 and ``.target`` (1797,) int64."""
    with np.load(DIGITS_FILE) as f:
        return types.SimpleNamespace(images=f["images"].astype(np.float64),
                                     target=f["target"].astype(np.int64))
