"""Shared network building blocks (counterpart of ``models/nets.py``).

Only the blocks on the serving slice's path.  Submodules carry the names
that flax gives their counterparts (``Dense_0``, ``LayerNorm_1``,
``MultiHeadAttention_0``, ...), so that ``bridge.load_flax_params`` maps a
flax parameter path onto a module path one to one.

Numerics that differ from PyTorch's defaults and follow flax: LayerNorm eps
is 1e-6 and GELU is the tanh approximation.  Public functions keep the
reference's layouts: NHWC images and (B, H, T, Dh) attention.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_vae_comparison_tpu_torch.ops.kernels.attention import masked_attention

LN_EPS = 1e-6  # flax.linen.LayerNorm default


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
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(kv_features, d_model)
        self.value = nn.Linear(kv_features, d_model)
        self.out = nn.Linear(d_model, d_model)

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
        out = masked_attention(q, k, v, key_mask)
        return self.out(out.transpose(1, 2).reshape(b, tq, d_model))


class TransformerEncoderLayer(nn.Module):
    """Post-norm transformer encoder layer."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int):
        super().__init__()
        self.MultiHeadAttention_0 = MultiHeadAttention(d_model, num_heads)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d_model, ff_size)
        self.Dense_1 = nn.Linear(ff_size, d_model)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=LN_EPS)

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


class ConvTranspose2dTorch(nn.Module):
    """2x up-sampling transposed conv, k=4, stride 2, padding 1, on NHWC.

    The permutes are views: cuDNN takes the NHWC tensor as a channels-last
    NCHW one, so no copy is made on either side."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(in_features, features, 4,
                                                  stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvTranspose_0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
