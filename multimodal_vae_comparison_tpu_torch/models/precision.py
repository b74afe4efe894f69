"""The compute dtype of the nets (the port of flax's ``dtype=`` on a layer).

The JAX package trains in bf16 by building every layer with ``dtype=bf16``
while its parameters stay fp32 (flax's ``param_dtype``).  The layers here
are PyTorch's with that one attribute added, ``compute_dtype``:

* a dtype (bf16): ``Linear`` and the convolutions cast their input, weight
  and bias to it and return it, as flax's ``promote_dtype`` does before a
  ``Dense``, ``Conv`` or ``ConvTranspose``; ``LayerNorm`` and
  ``GroupNorm`` normalize in fp32 (flax's ``_compute_stats`` and
  ``_normalize`` upcast) and return it;
* ``None`` (the default): the same calls in the dtype of the parameters
  (of the input, for the norms).  A cast to the dtype a tensor already has
  returns the tensor itself, so the fp32 path, and ``model.double()``'s
  fp64 one, compute exactly what PyTorch's own layers do.

This is an explicit cast at each layer, not ``torch.autocast``: autocast
keeps norms and residual sums in fp32 where flax rounds them to bf16, so it
would be another function.  Between the layers PyTorch's type promotion
(bf16 with fp32 is fp32, with a Python scalar bf16) is the JAX package's.

:func:`set_compute_dtype` sets the attribute on every module of a model;
composite modules that cast beside their layers read it too (an attention
output through :func:`to_compute`, a decoder's positional queries).
:func:`widen` (the kernels' own) takes a value up to fp32 where the
reference casts to ``float32``: a posterior, a sequence decoder's output.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_vae_comparison_tpu_torch.ops.kernels.attention import widen  # noqa: F401


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a sum over values of ``dtype`` is taken in: fp32 or wider."""
    return torch.promote_types(dtype, torch.float32)


def to_compute(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to ``module``'s compute dtype; unchanged where it has none."""
    dt = getattr(module, "compute_dtype", None)
    return x if dt is None else x.to(dt)


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Give every module of ``model`` the compute dtype ``dtype`` (fp32 and
    None leave each layer PyTorch's).  A module that sets ``fp32_only`` (the
    JAX package builds it with ``dtype=float32``) computes in fp32 instead,
    casting a narrower input up."""
    dt = None if dtype in (None, torch.float32) else dtype
    for m in model.modules():
        m.compute_dtype = torch.float32 if dt is not None and getattr(
            m, "fp32_only", False) else dt
    return model


def _cast(p: Optional[torch.Tensor], dt: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dt)


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``Dense``'s ``dtype``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class _CastConv:
    """The cast of flax ``Conv`` around ``_conv_forward``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv1d(_CastConv, nn.Conv1d):
    pass


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Conv3d(_CastConv, nn.Conv3d):
    pass


_TRANSPOSED = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


class _CastConvTranspose:
    """The cast of flax ``ConvTranspose`` around PyTorch's transposed conv
    (output size from the layer's own ``output_padding``)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return _TRANSPOSED[len(self.kernel_size)](
            x.to(dt), self.weight.to(dt), _cast(self.bias, dt), self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)


class ConvTranspose1d(_CastConvTranspose, nn.ConvTranspose1d):
    pass


class ConvTranspose2d(_CastConvTranspose, nn.ConvTranspose2d):
    pass


class ConvTranspose3d(_CastConvTranspose, nn.ConvTranspose3d):
    pass


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax ``LayerNorm``'s ``dtype``: statistics and
    the affine in fp32, the result in the compute dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(widen(x), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype or x.dtype)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` (channels first) with flax ``GroupNorm``'s ``dtype``:
    statistics and the affine in fp32, the result in the compute dtype."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(widen(x), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.compute_dtype or x.dtype)
