"""The perceptual reconstruction loss ``feature_loss`` (counterpart of
``models/perceptual.py``).

Pixel-space squared error plus a squared error over VGG conv-layer feature
maps of the reconstruction against the target.  The extractor
(:class:`~models.nets.VGGFeatures`) is frozen: its parameters take no
gradient, and it is no submodule of the VAE, so it is in no
``model.parameters()``, optimizer or checkpoint.  Gradients flow through it
to the reconstruction only; the target's features are computed without
one.  One copy per device and dtype is cached.

Its weights: the converted torchvision ``vgg19`` where
``eval/weights.find_weights_file("vgg19")`` finds one (source
``torchvision-vgg19``), else fixed random ones (``fixed-random``): flax's
default init (lecun_normal kernels, a normal of variance 1 / fan_in cut at
two standard deviations; zero biases), drawn in conv order from
``torch.Generator().manual_seed(0)`` on the CPU.  The JAX package draws its
fixed random weights from ``PRNGKey(0)``, which PyTorch cannot replay, so
a ``fixed-random`` loss or FID of the two packages is not comparable; with
one installed ``vgg19`` file it is.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from multimodal_vae_comparison_tpu_torch.models.precision import widen

_STATE: Optional[Dict[str, torch.Tensor]] = None
_SOURCE = "uninitialized"
_EXTRACTORS: Dict[Tuple[torch.device, torch.dtype], torch.nn.Module] = {}
# lecun_normal's truncated normal: its std corrected for the cut at 2 std
_TRUNCATED_STD = 0.87962566103423978


def _fixed_random_state() -> Dict[str, torch.Tensor]:
    from multimodal_vae_comparison_tpu_torch.models.nets import VGGFeatures
    g = torch.Generator().manual_seed(0)
    state = {}
    for name, p in VGGFeatures().state_dict().items():
        if name.endswith(".weight"):
            std = math.sqrt(1.0 / p[0].numel()) / _TRUNCATED_STD
            state[name] = torch.nn.init.trunc_normal_(torch.empty_like(p), 0.0, std,
                                                      -2 * std, 2 * std, generator=g)
        else:
            state[name] = torch.zeros_like(p)
    return state


def extractor_params() -> Dict[str, torch.Tensor]:
    """The extractor's state dict on the CPU: the installed ``vgg19``
    converted, else the fixed random weights.  Cached per process."""
    global _STATE, _SOURCE
    if _STATE is None:
        from multimodal_vae_comparison_tpu_torch.eval import weights as W
        with torch.inference_mode(False):   # cached: usable under autograd later
            state = W.vgg19_feature_params()
            if state is not None:
                _SOURCE = "torchvision-vgg19"
            else:
                state, _SOURCE = _fixed_random_state(), "fixed-random"
        _STATE = state
    return _STATE


def extractor_source() -> str:
    """``torchvision-vgg19`` or ``fixed-random``."""
    extractor_params()
    return _SOURCE


def reset_extractor_cache() -> None:
    """Drop the cached weights and extractors (the next call reads the
    weights directory again)."""
    global _STATE, _SOURCE
    _STATE, _SOURCE = None, "uninitialized"
    _EXTRACTORS.clear()


def extractor(device, dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """The frozen ``VGGFeatures`` on ``device`` in ``dtype``, cached."""
    from multimodal_vae_comparison_tpu_torch.eval.weights import load_checked
    from multimodal_vae_comparison_tpu_torch.models.nets import VGGFeatures
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev, dtype)
    if key not in _EXTRACTORS:
        with torch.inference_mode(False):
            net = VGGFeatures()
            load_checked(net, extractor_params(), "vgg19")
            _EXTRACTORS[key] = net.to(device=key[0], dtype=dtype).eval().requires_grad_(False)
    return _EXTRACTORS[key]


def feature_loss(dist, target, mask=None, batch_ndims=1):
    """Per-(K, B) log-likelihood contribution (higher is better): minus the
    pixel sum of squares, minus the per-sample mean squared error of each of
    the eight conv taps, summed and scaled by the pixel count.  Images (H,
    W, C) only; ``mask`` is ignored (as in the reference).  With
    ``batch_ndims`` 2 the (K, B) axes fold B-major, as the JAX package
    folds them."""
    recon = widen(dist.mean)   # the reference's fp32 extractor promotes a bf16 mean
    lead, img_shape = recon.shape[:batch_ndims], tuple(recon.shape[batch_ndims:])
    assert len(img_shape) == 3, (
        f"feature_loss is for (H, W, C) images, got feature shape {img_shape}")
    target = target.to(recon.dtype).broadcast_to(recon.shape)
    if batch_ndims == 2:
        recon, target = recon.transpose(0, 1), target.transpose(0, 1)
    flat_r = recon.reshape((-1,) + img_shape)
    flat_t = target.reshape((-1,) + img_shape).detach()
    net = extractor(flat_r.device, flat_r.dtype)
    feats_r = net(flat_r, taps="conv")
    with torch.no_grad():
        feats_t = net(flat_t, taps="conv")
    feat_mse = torch.zeros(flat_r.shape[0], dtype=flat_r.dtype, device=flat_r.device)
    for fr, ft in zip(feats_r, feats_t):
        feat_mse = feat_mse + (fr - ft).square().mean(dim=(1, 2, 3))
    pix_mse = (flat_r - flat_t).square().reshape(flat_r.shape[0], -1).sum(-1)
    ll = -(pix_mse + feat_mse * math.prod(img_shape))
    if batch_ndims == 2:
        return ll.reshape(lead[1], lead[0]).transpose(0, 1)
    return ll.reshape(lead)
