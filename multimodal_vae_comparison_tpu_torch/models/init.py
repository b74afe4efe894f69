"""flax's default initializers, for the port's layers.

The JAX package names no initializer in its nets, so every parameter there
takes flax's default for its layer, and a fresh port net draws the same:

* ``lecun_normal``: the kernel of every ``Dense``, ``DenseGeneral``,
  ``Conv`` and ``ConvTranspose`` (and a ``GRUCell``'s input kernels), a
  normal of variance 1 / fan_in cut at two standard deviations, its scale
  corrected for the cut.  The fan-in is what the flax kernel contracts
  over: a Dense's input features, a conv's input channels per group times
  its window, and a transposed conv's input channels times its window
  (flax lays its kernel out (*window, in, out); PyTorch's own default takes
  a transposed conv's fan-in from its output channels);
* zeros: every bias;
* ``orthogonal``: a ``GRUCell``'s recurrent kernel, one square block a gate.

The castable layers of ``models/precision.py`` draw through
:func:`lecun_layer_` in their ``reset_parameters``, so every net takes
these rules wherever it builds a layer; the judges and the fixed VGG
features draw through :func:`lecun_normal_` too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# the standard deviation of a standard normal cut at +-2, by which
# lecun_normal divides its scale
TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``w`` drawn in place from flax's lecun_normal for ``fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / TRUNCATED_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def lecun_layer_(layer: nn.Module, fan_in: int) -> None:
    """A layer's ``weight`` from lecun_normal for ``fan_in``, its bias zero."""
    lecun_normal_(layer.weight, fan_in)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def conv_fan_in(conv: nn.Module) -> int:
    """The fan-in flax gives a conv (``transposed`` or not) of this shape."""
    window = math.prod(conv.kernel_size)
    if conv.transposed:
        return conv.in_channels * window
    return conv.in_channels // conv.groups * window


def flax_gru_(gru: nn.GRU) -> None:
    """A one-layer ``nn.GRU`` drawn as flax draws a ``GRUCell``: each gate's
    input kernel lecun_normal, each gate's H x H recurrent kernel
    orthogonal, every bias zero."""
    h = gru.hidden_size
    with torch.no_grad():
        lecun_normal_(gru.weight_ih_l0, gru.input_size)
        for gate in range(3):
            nn.init.orthogonal_(gru.weight_hh_l0[gate * h:(gate + 1) * h])
        nn.init.zeros_(gru.bias_ih_l0)
        nn.init.zeros_(gru.bias_hh_l0)
