"""InceptionV3 trunk for Inception-FID features (counterpart of
``models/inception.py``).

torchvision's ``inception_v3`` topology up to its 2048-d average pool, with
FrozenBatchNorm (eps 1e-3) after every bias-free conv.  Submodules carry
torchvision's names (``Conv2d_1a_3x3.conv``, ``Mixed_5b.branch1x1.bn``,
...), so a torchvision state dict loads by key through
``eval/weights.convert_inception`` (its ``running_mean`` / ``running_var``
are FrozenBatchNorm's ``mean`` / ``var``), and the flax tree of the JAX
package through ``bridge.load_flax_params``.  NHWC at the interface, NCHW
inside.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_vae_comparison_tpu_torch.models.nets import FrozenBatchNorm
from multimodal_vae_comparison_tpu_torch.models.precision import Conv2d

Pair = Union[int, Tuple[int, int]]
INCEPTION_BN_EPS = 1e-3
SIZE = 299


class BasicConv(nn.Module):
    """torchvision's BasicConv2d: a conv without bias (drawn fresh as flax's
    ``nn.Conv``), FrozenBatchNorm (eps 1e-3), ReLU; on NCHW."""

    def __init__(self, in_channels: int, features: int, kernel: Pair, stride: int = 1,
                 padding: Pair = 0):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel, stride=stride, padding=padding,
                           bias=False)
        self.bn = FrozenBatchNorm(features, eps=INCEPTION_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean, stride 1, padded by 1 with the padding counted (flax's
    ``avg_pool`` as the JAX package calls it)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool3(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_channels, 64, 1)
        self.branch5x5_1 = BasicConv(in_channels, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(in_channels, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3 = BasicConv(in_channels, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(in_channels, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool3(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv(in_channels, 192, 1)
        self.branch7x7_1 = BasicConv(in_channels, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(in_channels, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(in_channels, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(in_channels, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(in_channels, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool3(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.branch1x1 = BasicConv(in_channels, 320, 1)
        self.branch3x3_1 = BasicConv(in_channels, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(in_channels, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(in_channels, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool3(x))], 1)


def resize_bilinear(x: torch.Tensor, size: int = SIZE) -> torch.Tensor:
    """NHWC images to (size, size) as ``jax.image.resize(..., "bilinear")``:
    half-pixel centres, and antialiased (the triangle filter widened by the
    scale) along an axis that shrinks."""
    shrinks = x.shape[1] > size or x.shape[2] > size
    h = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=shrinks)
    return h.permute(0, 2, 3, 1)


class InceptionV3(nn.Module):
    """2048-d pool-3 features of NHWC images in [0, 1] at any resolution:
    resized to 299 (unless ``resize_input`` is False), a one-channel image
    repeated to three, rescaled to [-1, 1]."""

    def __init__(self, resize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.resize_input and tuple(x.shape[1:3]) != (SIZE, SIZE):
            x = resize_bilinear(x)
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        h = (x * 2.0 - 1.0).permute(0, 3, 1, 2)
        h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(h)))
        h = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool3(h)))
        h = _max_pool3(h)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            h = getattr(self, name)(h)
        return h.mean(dim=(2, 3))
