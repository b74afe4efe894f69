"""Fréchet distance on in-memory images with a pluggable feature extractor
(counterpart of ``eval/fid.py``).

The Fréchet machinery (mean and covariance of the features, the matrix
square root by ``scipy.linalg.sqrtm``, imported where it is called) runs
in numpy, as in the JAX package.  The default features:

* InceptionV3 pool-3 (``models/inception.py``) when an ``inception_v3``
  file is installed (``eval/weights.py``): the reference's Inception-FID;
* else the spatial mean of VGG19's last pool map (``VGGFeatures``, the
  perceptual loss's extractor: the installed ``vgg19``, or its fixed
  random weights).  A VGG FID ranks runs against each other; it is no
  Inception-FID.

Every FID is reported with :func:`active_feature_net`'s label.  A
``vgg19_fixed_random`` FID of the port is not comparable with one of the
JAX package (each package draws its own fixed weights); ``vgg19_pretrained``
and ``inception_v3`` FIDs from the same file are.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from multimodal_vae_comparison_tpu_torch.device import resolve_device


def active_feature_net() -> str:
    """The label of the feature net :func:`default_feature_fn` uses now:
    ``inception_v3``, ``vgg19_pretrained`` or ``vgg19_fixed_random``."""
    from multimodal_vae_comparison_tpu_torch.eval import weights as W
    if W.find_weights_file("inception_v3") is not None:
        return "inception_v3"
    return "vgg19_pretrained" if W.find_weights_file("vgg19") else "vgg19_fixed_random"


def default_feature_fn(seed: int = 0, device=None) -> Callable[[np.ndarray], np.ndarray]:
    """A function of NHWC float images in [0, 1] (numpy) to their (N, F)
    features (numpy), computed on ``device`` (the card unless the caller
    asks for the CPU): InceptionV3's 2048 when an ``inception_v3`` file is
    installed, else the mean over H and W of VGG's last pool map (256).
    ``seed`` is the JAX package's argument, unused there too."""
    from multimodal_vae_comparison_tpu_torch.eval import weights as W
    from multimodal_vae_comparison_tpu_torch.models import perceptual
    dev = resolve_device(device)
    inception = W.inception_feature_params()
    if inception is not None:
        from multimodal_vae_comparison_tpu_torch.models.inception import InceptionV3
        net = InceptionV3()
        W.load_checked(net, inception, "inception_v3")
        net = net.to(dev).eval().requires_grad_(False)
        features = net
    else:
        vgg = perceptual.extractor(dev)
        features = lambda x: vgg(x)[-1].mean(dim=(1, 2))   # noqa: E731

    def fn(images: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(images, np.float32), device=dev)
            return features(x).cpu().numpy()

    return fn


def activation_statistics(images: np.ndarray, feature_fn, batch_size: int = 64):
    feats = []
    for b in range(0, len(images), batch_size):
        feats.append(feature_fn(images[b:b + batch_size]))
    feats = np.concatenate(feats)
    mu = feats.mean(0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (the reference's
    ``fid_score.py:140-180``).  ``sqrtm`` is called without ``disp``, which
    newer SciPy no longer takes: the same root on every version."""
    from scipy import linalg   # its import starts a process (numpy.testing's probe)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def calculate_fid_given_data(real: np.ndarray, generated: np.ndarray,
                             feature_fn: Optional[Callable] = None, device=None) -> float:
    """FID between two in-memory image sets, NHWC float in [0, 1] (the
    reference's ``fid_score.py:291-316``); without ``feature_fn`` the
    default features on ``device``, their label printed."""
    if feature_fn is None:
        print(f"[fid] feature net: {active_feature_net()}")
        feature_fn = default_feature_fn(device=device)
    mu1, s1 = activation_statistics(real, feature_fn)
    mu2, s2 = activation_statistics(generated, feature_fn)
    return frechet_distance(mu1, s1, mu2, s2)
