"""Shared network building blocks (counterpart of ``models/nets.py``).

The blocks of the ported models: the transformer pieces of the CdSprites+
text nets, the ResNet-50 trunk of ``Enc_CNN``, the ViT trunk of
``Enc_VIT``, the residual blocks of the RESCNN nets, the 3D conv and
attention blocks of the VideoGPT family, and VGG19's first convs (the
perceptual loss's extractor); and the reference's blocks that no encoder
or decoder of either package builds (``GroupNormMod``, ``MLP``, the
``MultiTransformer`` fusion net with its ``TransformerDecoder``,
``ResidualBlock1dConv`` and ``ResidualFeatureCompressor``).
Submodules carry the names
that flax gives their counterparts (``Dense_0``, ``LayerNorm_1``,
``MultiHeadAttention_0``, ...), so that ``bridge.load_flax_params`` maps a
flax parameter path onto a module path one to one.

Numerics that differ from PyTorch's defaults and follow flax: LayerNorm and
GroupNorm eps is 1e-6 (FrozenBatchNorm's 1e-5), GELU is the tanh
approximation, and ``SAME`` padding of an even kernel is asymmetric.
Every layer takes the compute dtype of ``models/precision.py`` (bf16 under
``precision: bf16``, parameters fp32); the attention modules cast their
kernel's fp32 output to it, as the reference's do.
Public functions keep the reference's layouts: NHWC images, (B, T, H, W, C)
video volumes and (B, H, T, Dh) attention; modules permute to
channels-first views around PyTorch's convs (``ResDown`` and ``ResUp``, the
inner blocks of the RESCNN nets, take and return NCHW, so that the stack
permutes once).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_vae_comparison_tpu_torch.models import precision
from multimodal_vae_comparison_tpu_torch.constants import ETA
from multimodal_vae_comparison_tpu_torch.models.precision import (
    Conv1d, Conv2d, Conv3d, ConvTranspose2d, ConvTranspose3d, LayerNorm, Linear, to_compute)
from multimodal_vae_comparison_tpu_torch.ops.kernels.attention import masked_attention
from multimodal_vae_comparison_tpu_torch.ops.kernels.sparse_attention import (
    strided_block_sparse_attention)

LN_EPS = 1e-6  # flax.linen.LayerNorm and GroupNorm default
BN_EPS = 1e-5  # the reference's FrozenBatchNorm


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def positional_encoding(length: int, dim: int, device=None,
                        dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal positional encoding table of shape (length, dim)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(0, dim, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, i / dim)
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)[:, : dim // 2]
    return pe.to(dtype)


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections around the masked attention kernel.

    flax keeps q/k/v as ``DenseGeneral`` to (H, Dh); here each is one
    ``nn.Linear`` to H*Dh, split into heads after the projection."""

    def __init__(self, d_model: int, num_heads: int,
                 kv_features: Optional[int] = None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"num_heads {num_heads}")
        kv_features = kv_features or d_model
        self.num_heads = num_heads
        self.query = Linear(d_model, d_model)
        self.key = Linear(kv_features, d_model)
        self.value = Linear(kv_features, d_model)
        self.out = Linear(d_model, d_model)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads
        return x.view(b, t, h, d // h).transpose(1, 2).contiguous()

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:param key_mask: optional (B, Tk) bool, True = attend"""
        b, tq, d_model = q_in.shape
        q = self._heads(self.query(q_in))
        k = self._heads(self.key(kv_in))
        v = self._heads(self.value(kv_in))
        if key_mask is not None:
            key_mask = key_mask.to(torch.bool).contiguous()
        out = to_compute(self, masked_attention(q, k, v, key_mask))
        return self.out(out.transpose(1, 2).reshape(b, tq, d_model))


class TransformerEncoderLayer(nn.Module):
    """Post-norm transformer encoder layer."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int):
        super().__init__()
        self.MultiHeadAttention_0 = MultiHeadAttention(d_model, num_heads)
        self.LayerNorm_0 = LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = Linear(d_model, ff_size)
        self.Dense_1 = Linear(ff_size, d_model)
        self.LayerNorm_1 = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, key_mask=None):
        x = self.LayerNorm_0(x + self.MultiHeadAttention_0(x, x, key_mask))
        h = self.Dense_1(gelu(self.Dense_0(x)))
        return self.LayerNorm_1(x + h)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 ff_size: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"TransformerEncoderLayer_{i}",
                            TransformerEncoderLayer(d_model, num_heads, ff_size))

    def forward(self, x, key_mask=None):
        for i in range(self.num_layers):
            x = getattr(self, f"TransformerEncoderLayer_{i}")(x, key_mask)
        return x


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: self-attention over the queries, then
    cross-attention to the memory, then the feed-forward block."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int,
                 memory_features: Optional[int] = None):
        super().__init__()
        self.MultiHeadAttention_0 = MultiHeadAttention(d_model, num_heads)
        self.LayerNorm_0 = LayerNorm(d_model, eps=LN_EPS)
        self.MultiHeadAttention_1 = MultiHeadAttention(d_model, num_heads, memory_features)
        self.LayerNorm_1 = LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = Linear(d_model, ff_size)
        self.Dense_1 = Linear(ff_size, d_model)
        self.LayerNorm_2 = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, tgt_key_mask=None, mem_key_mask=None):
        tgt = self.LayerNorm_0(tgt + self.MultiHeadAttention_0(tgt, tgt, tgt_key_mask))
        tgt = self.LayerNorm_1(tgt + self.MultiHeadAttention_1(tgt, memory, mem_key_mask))
        return self.LayerNorm_2(tgt + self.Dense_1(gelu(self.Dense_0(tgt))))


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int, ff_size: int,
                 memory_features: Optional[int] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"TransformerDecoderLayer_{i}", TransformerDecoderLayer(
                d_model, num_heads, ff_size, memory_features))

    def forward(self, tgt, memory, tgt_key_mask=None, mem_key_mask=None):
        for i in range(self.num_layers):
            tgt = getattr(self, f"TransformerDecoderLayer_{i}")(tgt, memory, tgt_key_mask,
                                                                mem_key_mask)
        return tgt


class MLP(nn.Module):
    """Dense layers of ``features`` widths from ``in_features``, each but the
    last (or every one, with ``activate_final``) followed by ``activation``."""

    def __init__(self, in_features: int, features: Sequence[int], activation=F.relu,
                 activate_final: bool = False):
        super().__init__()
        self.activation, self.activate_final = activation, activate_final
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", Linear(in_features, f))
            in_features = f

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n - 1 or self.activate_final:
                x = self.activation(x)
        return x


class MultiTransformer(nn.Module):
    """Transformer fusion network over stacked per-modality latent tokens
    (reference nn_modules.py:65-142): embeds a (B, T, in_features) sequence
    of latent vectors (``skel_embedding``), runs a masked encoder
    (optionally followed by a time-query decoder), and emits fused (mu,
    scale) in fp32.  ``zero_masking`` masks all-zero rows (the reference's
    padded-modality convention)."""

    def __init__(self, in_features: int, latent_dim: int, num_layers: int = 2,
                 num_heads: int = 2, ff_size: int = 2048, zero_masking: bool = False,
                 use_decoder: bool = False, use_ml_layers: bool = True,
                 output_mean: bool = True, pos_encoding: bool = True):
        super().__init__()
        self.latent_dim, self.zero_masking = latent_dim, zero_masking
        self.use_decoder, self.use_ml_layers = use_decoder, use_ml_layers
        self.output_mean, self.pos_encoding = output_mean, pos_encoding
        self.skel_embedding = Linear(in_features, latent_dim)
        self.TransformerEncoder_0 = TransformerEncoder(num_layers, latent_dim, num_heads,
                                                       ff_size)
        if use_decoder:
            self.TransformerDecoder_0 = TransformerDecoder(num_layers, latent_dim,
                                                           num_heads, ff_size)
        if use_ml_layers:
            self.mu_layer = Linear(latent_dim, latent_dim)
            self.logvar_layer = Linear(latent_dim, latent_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        b, t = x.shape[0], x.shape[1]
        x = x.reshape(b, t, -1)
        if mask is None and self.zero_masking:
            mask = (x != 0).any(-1)
        h = self.skel_embedding(x)
        if self.pos_encoding:
            h = h + positional_encoding(t, self.latent_dim, h.device, h.dtype)[None]
        h = self.TransformerEncoder_0(h, mask)
        if self.use_decoder:
            queries = positional_encoding(t, self.latent_dim, h.device,
                                          h.dtype)[None].expand(b, t, self.latent_dim)
            h = self.TransformerDecoder_0(queries, h, tgt_key_mask=mask)
        if not self.use_ml_layers:
            mu, raw = h[:, 0], h[:, 1]
        else:
            z = h.mean(dim=1) if self.output_mean else h[:, 0]
            mu, raw = self.mu_layer(z), self.logvar_layer(z)
        scale = torch.softmax(raw.float(), dim=-1) + ETA
        return mu.float(), scale


class ConvTranspose2dTorch(nn.Module):
    """2x up-sampling transposed conv, k=4, stride 2, padding 1, on NHWC.

    The permutes are views: cuDNN takes the NHWC tensor as a channels-last
    NCHW one, so no copy is made on either side."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose2d(in_features, features, 4,
                                                  stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvTranspose_0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# -- VideoGPT-style 3D blocks -------------------------------------------------

def group_norm(channels: int) -> nn.GroupNorm:
    """The reference's ``group_norm`` on channels-first input: gcd(8, C)
    groups and flax's eps."""
    return precision.GroupNorm(math.gcd(8, channels), channels, eps=LN_EPS)


class GroupNorm(precision.GroupNorm):
    """The reference's ``group_norm`` on channels-last input: gcd(8, C)
    groups and flax's eps."""

    def __init__(self, channels: int):
        super().__init__(math.gcd(8, channels), channels, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.movedim(-1, 1)).movedim(1, -1)


class GroupNormMod(nn.Module):
    """flax ``GroupNorm`` of gcd(``groups``, C) groups over channels-last
    input (the reference's module wrapper of ``group_norm``)."""

    def __init__(self, channels: int, groups: int = 8):
        super().__init__()
        self.GroupNorm_0 = precision.GroupNorm(math.gcd(groups, channels), channels,
                                               eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(x.movedim(-1, 1)).movedim(1, -1)


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding of one axis: the output is ceil(size/stride)
    long and the odd element of padding goes after."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SamePadConv3d(nn.Module):
    """``nn.Conv(kernel^3, strides, padding="SAME")`` on (B, T, H, W, C)."""

    def __init__(self, in_features: int, features: int, kernel: int = 4,
                 strides: Sequence[int] = (1, 1, 1)):
        super().__init__()
        self.kernel, self.strides = kernel, tuple(strides)
        self.Conv_0 = Conv3d(in_features, features, kernel, stride=self.strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = [_same_pads(n, self.kernel, s)
                for n, s in zip(x.shape[1:4], self.strides)]
        h = F.pad(x.permute(0, 4, 1, 2, 3), pads[2] + pads[1] + pads[0])
        return self.Conv_0(h).permute(0, 2, 3, 4, 1)


def resample_strides(factors: Sequence[int]):
    """The (t, h, w) strides of the VideoGPT down- or up-sampling stack: one
    conv per halving of the most-resampled axis, each axis strided 2 until
    its own factor is used up."""
    remaining = [int(math.log2(f)) for f in factors]
    out = []
    for _ in range(max(remaining)):
        out.append(tuple(2 if r > 0 else 1 for r in remaining))
        remaining = [r - 1 for r in remaining]
    return out


def transpose_crops(kernel: int, stride: int) -> Tuple[int, int]:
    """What to cut from each end of a full transposed conv (PyTorch's with no
    padding) to get flax/XLA's ``SAME`` one, whose output is size * stride."""
    pad_len = kernel + stride - 2
    pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return kernel - 1 - pad_a, kernel - 1 - (pad_len - pad_a)


class SamePadConvTranspose3d(nn.Module):
    """``nn.ConvTranspose(kernel^3, strides, padding="SAME")`` on
    (B, T, H, W, C): PyTorch's transposed conv on the flipped kernel (the
    bridge flips it), with the padding both ends share given to PyTorch and
    the rest cut off after (kernel 4, stride 1: one more slice at the end)."""

    def __init__(self, in_features: int, features: int, kernel: int = 4,
                 strides: Sequence[int] = (1, 1, 1)):
        super().__init__()
        crops = [transpose_crops(kernel, s) for s in strides]
        padding = tuple(min(c) for c in crops)
        self.extra = tuple((lo - p, hi - p) for (lo, hi), p in zip(crops, padding))
        self.ConvTranspose_0 = ConvTranspose3d(in_features, features, kernel,
                                                  stride=tuple(strides), padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ConvTranspose_0(x.permute(0, 4, 1, 2, 3))
        for axis, (lo, hi) in enumerate(self.extra, start=2):
            if lo or hi:
                h = h.narrow(axis, lo, h.shape[axis] - lo - hi)
        return h.permute(0, 2, 3, 4, 1)


class AxialAttention(nn.Module):
    """Axial self-attention over a (B, T, H, W, C) volume: attention along
    one of T, H, W at a time, the three summed."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        for name in "thw":
            self.add_module(f"axial_{name}", MultiHeadAttention(channels, num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = 0.0
        for axis, name in ((1, "t"), (2, "h"), (3, "w")):
            xp = x.movedim(axis, 3)                          # (..., L, C)
            flat = xp.reshape(-1, xp.shape[-2], xp.shape[-1])
            att = getattr(self, f"axial_{name}")(flat, flat)
            out = out + att.reshape(xp.shape).movedim(3, axis)
        return out


class StridedSparseSelfAttention(nn.Module):
    """Causal strided block-sparse self-attention over (B, T, C): q/k/v/out
    projections around ``strided_block_sparse_attention``.  T is padded with
    zeros to a block multiple (padded keys come after every real query, so
    they are causally invisible) and cut back after."""

    def __init__(self, d_model: int, num_heads: int, block: int = 128,
                 block_stride: int = 4):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads, self.block, self.block_stride = num_heads, block, block_stride
        self.query = Linear(d_model, d_model)
        self.key = Linear(d_model, d_model)
        self.value = Linear(d_model, d_model)
        self.out = Linear(d_model, d_model)

    def _heads(self, x: torch.Tensor, pad: int) -> torch.Tensor:
        b, t, c = x.shape
        x = x.view(b, t, self.num_heads, c // self.num_heads).transpose(1, 2)
        return (F.pad(x, (0, 0, 0, pad)) if pad else x).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        pad = (-t) % self.block
        q, k, v = (self._heads(proj(x), pad)
                   for proj in (self.query, self.key, self.value))
        out = to_compute(self, strided_block_sparse_attention(
            q, k, v, block=self.block, block_stride=self.block_stride))
        return self.out(out[:, :, :t].transpose(1, 2).reshape(b, t, c))


class _AttentionResidual(nn.Module):
    """norm-relu-conv3, norm-relu-conv1, norm-relu, attention, residual: the
    trunk the two VideoGPT attention-residual blocks share."""

    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(channels)
        self.SamePadConv3d_0 = SamePadConv3d(channels, channels // 2, kernel=3)
        self.GroupNorm_1 = GroupNorm(channels // 2)
        self.SamePadConv3d_1 = SamePadConv3d(channels // 2, channels, kernel=1)
        self.GroupNorm_2 = GroupNorm(channels)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        h = self.SamePadConv3d_0(F.relu(self.GroupNorm_0(x)))
        h = self.SamePadConv3d_1(F.relu(self.GroupNorm_1(h)))
        return F.relu(self.GroupNorm_2(h))


class AttentionResidualBlock(_AttentionResidual):
    """VideoGPT attention-residual block with axial attention."""

    def __init__(self, channels: int):
        super().__init__(channels)
        self.AxialAttention_0 = AxialAttention(channels, num_heads=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.AxialAttention_0(self.trunk(x))


class SparseAttentionResidualBlock(_AttentionResidual):
    """VideoGPT attention-residual block with ``attn_type='sparse'``: the
    (B, T, H, W, C) volume flattens to one spacetime token sequence, T
    slowest, and runs the strided block-sparse attention."""

    def __init__(self, channels: int, block: int = 128, block_stride: int = 4):
        super().__init__(channels)
        self.StridedSparseSelfAttention_0 = StridedSparseSelfAttention(
            channels, num_heads=2, block=block, block_stride=block_stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.trunk(x)
        b, t, hh, ww, c = h.shape
        att = self.StridedSparseSelfAttention_0(h.reshape(b, t * hh * ww, c))
        return x + att.reshape(b, t, hh, ww, c)


# -- residual conv blocks (the RESCNN nets) ----------------------------------

class ResDown(nn.Module):
    """Residual down-sampling block on NCHW: a 3x3 stride-2 skip conv, and
    3x3 stride-2 (C/2) -> GroupNorm -> ELU -> 3x3 (C) -> GroupNorm; ELU of
    the sum."""

    def __init__(self, in_features: int, channels: int):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, channels, 3, stride=2, padding=1)
        self.Conv_1 = Conv2d(in_features, channels // 2, 3, stride=2, padding=1)
        self.GroupNorm_0 = group_norm(channels // 2)
        self.Conv_2 = Conv2d(channels // 2, channels, 3, padding=1)
        self.GroupNorm_1 = group_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.elu(self.GroupNorm_0(self.Conv_1(x)))
        h = self.GroupNorm_1(self.Conv_2(h))
        return F.elu(h + self.Conv_0(x))


class ResUp(nn.Module):
    """Residual up-sampling block on NCHW: a 2x nearest up-sampling (the
    reference's ``jax.image.resize(..., "nearest")`` at exactly 2x), then a
    3x3 skip conv, and 3x3 (C/2) -> GroupNorm -> ELU -> 3x3 (C) ->
    GroupNorm; ELU of the sum."""

    def __init__(self, in_features: int, channels: int):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, channels, 3, padding=1)
        self.Conv_1 = Conv2d(in_features, channels // 2, 3, padding=1)
        self.GroupNorm_0 = group_norm(channels // 2)
        self.Conv_2 = Conv2d(channels // 2, channels, 3, padding=1)
        self.GroupNorm_1 = group_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = F.interpolate(x, scale_factor=2, mode="nearest")
        h = F.elu(self.GroupNorm_0(self.Conv_1(up)))
        h = self.GroupNorm_1(self.Conv_2(h))
        return F.elu(h + self.Conv_0(up))


# -- ViT trunk (Enc_VIT's backbone) --------------------------------------------

class _SameConv1d(Conv1d):
    """flax ``nn.Conv`` of one spatial axis with ``SAME`` padding, on
    channels-first (B, C, L) input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _same_pads(x.shape[-1], self.kernel_size[0], self.stride[0])
        return super().forward(F.pad(x, pads))


class ResidualBlock1dConv(nn.Module):
    """Weighted-residual 1D conv block on channels-last (B, L, C) input
    (reference nn_modules.py:144-177, MoPoE feature compressors): out =
    a*residual + b*conv_path, the residual a strided 1x1 conv where the
    channels or the stride change."""

    def __init__(self, channels_in: int, channels_out: int, kernel: int = 1,
                 strides: int = 1, a: float = 2.0, b: float = 0.3):
        super().__init__()
        self.a, self.b = a, b
        self.GroupNorm_0 = group_norm(channels_in)
        self.Conv_0 = _SameConv1d(channels_in, channels_out, kernel, stride=strides)
        self.GroupNorm_1 = group_norm(channels_out)
        self.Conv_1 = _SameConv1d(channels_out, channels_out, kernel)
        if channels_in != channels_out or strides != 1:
            self.Conv_2 = _SameConv1d(channels_in, channels_out, 1, stride=strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.movedim(-1, 1)
        h = self.Conv_0(F.relu(self.GroupNorm_0(x)))
        h = self.Conv_1(F.relu(self.GroupNorm_1(h)))
        residual = self.Conv_2(x) if hasattr(self, "Conv_2") else x
        return (self.a * residual + self.b * h).movedim(1, -1)


class ResidualFeatureCompressor(nn.Module):
    """Residual 1D-conv compressor emitting style/content (mu, raw-scale)
    pairs (reference nn_modules.py:210-228, from the MoPoE repo)."""

    def __init__(self, channels_in: int, out_style: int, out_content: int,
                 a: float = 2.0, b: float = 0.3):
        super().__init__()
        for name, out in (("style_mu", out_style), ("style_logvar", out_style),
                          ("content_mu", out_content), ("content_logvar", out_content)):
            self.add_module(name, ResidualBlock1dConv(channels_in, out, a=a, b=b))

    def forward(self, feats: torch.Tensor):
        return (self.style_mu(feats), self.style_logvar(feats),
                self.content_mu(feats), self.content_logvar(feats))


class ViT(nn.Module):
    """Compact ViT on NHWC images: a ``patch`` x ``patch`` conv of stride
    ``patch`` (flax's ``SAME`` padding, none at 64 px) to ``width``-wide
    tokens in row-major order, a learned ``cls`` token (zeros) in front, a
    learned ``pos_embed`` (normal, std 0.02), the post-norm encoder (depth 6,
    8 heads, MLP 4x width) with no mask, and ``Dense(num_outputs)`` on the
    cls token.  At 64 px: 16 patch tokens + cls, attention at Dh 32."""

    def __init__(self, image_hw: Sequence[int], in_channels: int = 3, patch: int = 16,
                 width: int = 256, depth: int = 6, heads: int = 8,
                 num_outputs: int = 1000):
        super().__init__()
        self.patch = patch
        n_tokens = 1 + math.prod(-(-int(n) // patch) for n in image_hw)
        self.Conv_0 = Conv2d(in_channels, width, patch, stride=patch)
        self.cls = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, n_tokens, width))
        self.TransformerEncoder_0 = TransformerEncoder(depth, width, heads, width * 4)
        self.Dense_0 = Linear(width, num_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        h_pad = _same_pads(x.shape[1], self.patch, self.patch)
        w_pad = _same_pads(x.shape[2], self.patch, self.patch)
        h = x.permute(0, 3, 1, 2)
        if any(h_pad + w_pad):
            h = F.pad(h, w_pad + h_pad)
        h = self.Conv_0(h).flatten(2).transpose(1, 2)        # (B, tokens, width)
        h = torch.cat([self.cls.expand(b, -1, -1).to(h.dtype), h], dim=1)
        h = self.TransformerEncoder_0(h + self.pos_embed.to(h.dtype))
        return self.Dense_0(h[:, 0])


# -- ResNet-50 trunk (Enc_CNN's backbone) ------------------------------------

class FrozenBatchNorm(nn.Module):
    """Inference-mode batch norm over the channels of an NCHW tensor:
    ``(x - mean) * scale / sqrt(var + eps) + bias`` with the stored
    statistics, as one ``F.batch_norm`` (the reference's XLA computes it
    elementwise, as ``x * inv + shift``: the same function, which PyTorch
    would take eight kernels forward and about fifteen backward to spell
    out).  ``weight`` (flax's ``scale``) and ``bias`` train; ``mean`` and
    ``var`` are buffers, which no optimizer sees and ``state_dict`` (so
    every checkpoint) carries.  At init (mean 0, var 1) it is a learnable
    affine.  ``eps`` is the ResNet-50's BN_EPS unless given (InceptionV3's
    convs take 1e-3).  Under a compute dtype it takes the reference's
    elementwise form, its folded scale and shift cast to that dtype."""

    def __init__(self, channels: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return F.batch_norm(x, self.mean, self.var, self.weight, self.bias,
                                training=False, eps=self.eps)
        # the reference's form under a compute dtype: the folded scale and
        # shift rounded to it, then x * inv + shift in it
        rs = torch.rsqrt(self.var + self.eps)
        inv = (self.weight * rs).to(dt)[:, None, None]
        shift = (self.bias - self.mean * self.weight * rs).to(dt)[:, None, None]
        return x.to(dt) * inv + shift


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 (4x the width) convs, each followed by
    a FrozenBatchNorm, ReLU between; a 1x1 projection of the input where
    its shape differs from the output's (each stage's first block)."""

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, features, 1, bias=False)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(features)
        self.Conv_1 = Conv2d(features, features, 3, stride=strides, padding=1,
                                bias=False)
        self.FrozenBatchNorm_1 = FrozenBatchNorm(features)
        self.Conv_2 = Conv2d(features, features * 4, 1, bias=False)
        self.FrozenBatchNorm_2 = FrozenBatchNorm(features * 4)
        self.project = in_features != features * 4 or strides != 1
        if self.project:
            self.Conv_3 = Conv2d(in_features, features * 4, 1, stride=strides,
                                    bias=False)
            self.FrozenBatchNorm_3 = FrozenBatchNorm(features * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.FrozenBatchNorm_0(self.Conv_0(x)))
        h = F.relu(self.FrozenBatchNorm_1(self.Conv_1(h)))
        h = self.FrozenBatchNorm_2(self.Conv_2(h))
        residual = self.FrozenBatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(h + residual)


class ResNet50(nn.Module):
    """ResNet-50 topology on NHWC images: 7x7/2 stem, 3x3/2 max pool, four
    stages of (3, 4, 6, 3) bottleneck blocks (stride 2 in the first block of
    stages 1-3), spatial mean, ``Dense(num_outputs)``.  The input is
    permuted once to an NCHW view (channels-last in memory, as cuDNN takes
    it).  Random init; ``eval/weights.install_pretrained`` loads a
    torchvision ``resnet50`` file into it where one is installed."""

    def __init__(self, in_channels: int = 3, num_outputs: int = 1000,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.Conv_0 = Conv2d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.FrozenBatchNorm_0 = FrozenBatchNorm(64)
        self.n_blocks, channels = 0, 64
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                block = BottleneckBlock(channels, 64 * 2 ** i,
                                        strides=2 if i > 0 and j == 0 else 1)
                self.add_module(f"BottleneckBlock_{self.n_blocks}", block)
                channels = 64 * 2 ** i * 4
                self.n_blocks += 1
        self.Dense_0 = Linear(channels, num_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.FrozenBatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2))))
        # flax pads the pool with -inf, as PyTorch does
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for i in range(self.n_blocks):
            h = getattr(self, f"BottleneckBlock_{i}")(h)
        return self.Dense_0(h.mean(dim=(2, 3)))


# -- VGG19's first convs (the perceptual loss's extractor, the FID's features) --

class VGGFeatures(nn.Module):
    """VGG19's first eight 3x3 convs (``cfg`` 64, 64, M, 128, 128, M, 256 x 4,
    M; ReLU after each conv, 2x2 max pools) on NHWC images.  ``taps="pool"``
    returns one map per max pool (the FID's), ``taps="conv"`` every conv's
    output before its ReLU (``feature_loss``'s), each NHWC.  The convs are
    ``Conv_0`` .. ``Conv_7``, flax's names, so that the bridge and
    ``eval/weights.convert_vgg19`` fill them."""

    CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M")

    def __init__(self, in_channels: int = 3, cfg: Sequence = CFG):
        super().__init__()
        self.cfg = tuple(cfg)
        n = 0
        for v in self.cfg:
            if v != "M":
                self.add_module(f"Conv_{n}", Conv2d(in_channels, v, 3, padding=1))
                in_channels, n = v, n + 1

    def forward(self, x: torch.Tensor, taps: str = "pool"):
        pool_feats, conv_feats = [], []
        h, n = x.permute(0, 3, 1, 2), 0
        for v in self.cfg:
            if v == "M":
                h = F.max_pool2d(h, 2, stride=2)
                pool_feats.append(h)
            else:
                h = getattr(self, f"Conv_{n}")(h)
                conv_feats.append(h)
                h, n = F.relu(h), n + 1
        feats = conv_feats if taps == "conv" else pool_feats
        return [f.permute(0, 2, 3, 1) for f in feats]
