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

Their fresh weights are flax's, not PyTorch's: ``reset_parameters`` draws
every kernel from lecun_normal with the fan-in of the flax layer and zeroes
every bias (``models/init.py``).

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

from multimodal_vae_comparison_tpu_torch.models.init import conv_fan_in, lecun_layer_
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
    """``nn.Linear`` with flax ``Dense``'s ``dtype`` and initializers (a
    DenseGeneral contracts over the same ``in_features``)."""

    compute_dtype: Optional[torch.dtype] = None

    def reset_parameters(self) -> None:
        lecun_layer_(self, self.in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class _CastConv:
    """The cast of flax ``Conv`` around ``_conv_forward``, and its
    initializers."""

    compute_dtype: Optional[torch.dtype] = None

    def reset_parameters(self) -> None:
        lecun_layer_(self, conv_fan_in(self))

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

# rows of the batch that one call of a 3-D transposed conv's weight gradient
# sums over (:class:`_BlockedWeightGrad`)
WGRAD_ROWS = 8


class _BlockedWeightGrad(torch.autograd.Function):
    """``F.conv_transpose3d`` whose weight gradient is summed over the batch
    in blocks of at most ``rows`` rows, a call each, the blocks' sums added
    in order; its input and bias gradients are one call, as PyTorch's.

    An element of a 3-D transposed conv's weight gradient sums a product
    for every input position of every row (~10^6 in the video decoders).
    cuDNN's deterministic algorithms take it as one long fp32 chain, whose
    rounding is as large as the gradient the cancellation leaves (the CPU's
    chain the same); blocks of a few rows keep each chain short, and every
    block's order is fixed, so the sum is as deterministic as before."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, output_padding, groups, dilation, rows):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, dilation, output_padding, groups)
        ctx.rows, ctx.bias_sizes = rows, None if b is None else list(b.shape)
        return F.conv_transpose3d(x, w, b, stride, padding, output_padding, groups, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, output_padding, groups = ctx.conv
        need_x, need_w, need_b = ctx.needs_input_grad[:3]

        def grads(g_, x_, mask):
            return torch.ops.aten.convolution_backward(
                g_, x_, w, ctx.bias_sizes, stride, padding, dilation, True, output_padding,
                groups, mask)

        gx, _, gb = grads(g, x, [need_x, False, need_b])
        gw = None
        if need_w:
            for start in range(0, x.shape[0], ctx.rows):
                part = grads(g[start:start + ctx.rows], x[start:start + ctx.rows],
                             [False, True, False])[1]
                gw = part if gw is None else gw + part
        return gx, gw, gb, None, None, None, None, None, None


class _CastConvTranspose:
    """The cast of flax ``ConvTranspose`` around PyTorch's transposed conv
    (output size from the layer's own ``output_padding``).  A 3-D one in
    fp32 or wider takes its weight gradient in blocks of WGRAD_ROWS rows
    (:class:`_BlockedWeightGrad`); in bf16 the operands' rounding outweighs
    the chain's, and the blocks' partial sums would each be rounded.  Its
    fresh kernel takes flax's fan-in, from the input channels."""

    compute_dtype: Optional[torch.dtype] = None

    def reset_parameters(self) -> None:
        lecun_layer_(self, conv_fan_in(self))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        args = (x.to(dt), self.weight.to(dt), _cast(self.bias, dt), self.stride, self.padding,
                self.output_padding, self.groups, self.dilation)
        if len(self.kernel_size) == 3 and dt.itemsize >= 4:
            return _BlockedWeightGrad.apply(*args, WGRAD_ROWS)
        return _TRANSPOSED[len(self.kernel_size)](*args)


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
