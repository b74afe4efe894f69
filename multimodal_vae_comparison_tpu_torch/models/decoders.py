"""Decoders on the serving slice's path (counterpart of ``models/decoders.py``).

Decoders take ``(z, mask)`` with z of shape (B, total_latents) and return
``(mean, scale)`` (image decoders also the clipped logits), with ``scale``
the fixed likelihood scale ``DEC_SCALE``.  Images come out NHWC.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_vae_comparison_tpu_torch.constants import DEC_SCALE, ETA
from multimodal_vae_comparison_tpu_torch.models.nets import (
    LN_EPS, ConvTranspose2dTorch, MultiHeadAttention, gelu, positional_encoding)

# logit(1 - ETA): clipping logits to +-this bound == clipping sigmoid(x) to
# [ETA, 1-ETA] (see VaeDecoder.squash_dist)
_LOGIT_BOUND = float(np.log((1.0 - ETA) / ETA))


class VaeDecoder(nn.Module):
    """Base decoder: holds dims."""

    def __init__(self, latent_dim: int, data_dim: Sequence[int],
                 latent_private: Optional[int] = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.data_dim = tuple(data_dim)
        self.latent_private = latent_private

    @property
    def out_dim(self) -> int:
        return self.latent_dim + (self.latent_private or 0)

    @staticmethod
    def scale_like(mean: torch.Tensor) -> torch.Tensor:
        return torch.full((), DEC_SCALE, dtype=torch.float32, device=mean.device)

    def squash_dist(self, h: torch.Tensor, b: int):
        """(mean, scale, clipped_logits): the eta clamp applied in logit
        space, ``sigmoid(clip(x, +-B))`` with ``B = logit(1-eta)``."""
        x = torch.clamp(h, -_LOGIT_BOUND, _LOGIT_BOUND).reshape(b, *self.data_dim)
        mean = torch.sigmoid(x)
        return mean, self.scale_like(mean), x


class Dec_CNN(VaeDecoder):
    """MLP + transposed-conv decoder from a 4x4 seed to NHWC ``data_dim``."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hid_channels: int = 32, hidden_dim: int = 512):
        super().__init__(latent_dim, data_dim, latent_private)
        out_hw = int(self.data_dim[0])
        out_ch = int(self.data_dim[-1]) if len(self.data_dim) >= 3 else 3
        self.n_up = max(int(round(np.log2(out_hw / 4))), 1)  # 4x4 seed -> out_hw
        self.hid_channels = hid_channels
        self.Dense_0 = nn.Linear(self.out_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, hidden_dim)
        self.Dense_2 = nn.Linear(hidden_dim, hid_channels * 16)
        for i in range(self.n_up):
            self.add_module(f"ConvTranspose2dTorch_{i}", ConvTranspose2dTorch(
                hid_channels, out_ch if i == self.n_up - 1 else hid_channels))

    def forward(self, z: torch.Tensor, mask=None):
        b = z.shape[0]
        h = F.relu(self.Dense_0(z))
        h = F.relu(self.Dense_1(h))
        h = F.relu(self.Dense_2(h))
        h = h.reshape(b, 4, 4, self.hid_channels)   # NHWC, as the reference
        for i in range(self.n_up):
            h = getattr(self, f"ConvTranspose2dTorch_{i}")(h)
            if i < self.n_up - 1:
                h = F.relu(h)
        return self.squash_dist(h, b)


def _add_time_query_layers(dec: nn.Module, d_model: int, num_layers: int,
                           num_heads: int, ff_size: int) -> None:
    """Register the layers of ``_time_query_decode`` on ``dec`` under the
    reference's names (cross_attn_i, ln1_i, ff1_i, ff2_i, ln2_i)."""
    for i in range(num_layers):
        dec.add_module(f"cross_attn_{i}", MultiHeadAttention(d_model, num_heads))
        dec.add_module(f"ln1_{i}", nn.LayerNorm(d_model, eps=LN_EPS))
        dec.add_module(f"ff1_{i}", nn.Linear(d_model, ff_size))
        dec.add_module(f"ff2_{i}", nn.Linear(ff_size, d_model))
        dec.add_module(f"ln2_{i}", nn.LayerNorm(d_model, eps=LN_EPS))


def _time_query_decode(dec: nn.Module, z: torch.Tensor, seq_len: int,
                       d_model: int, num_layers: int) -> torch.Tensor:
    """Positional time-queries cross-attend to z as a single-token memory;
    no self-attention among the queries (see the reference's docstring)."""
    b = z.shape[0]
    h = positional_encoding(seq_len, d_model, device=z.device,
                            dtype=z.dtype)[None].expand(b, seq_len, d_model)
    memory = z[:, None, :]
    for i in range(num_layers):
        att = getattr(dec, f"cross_attn_{i}")(h, memory)
        h = getattr(dec, f"ln1_{i}")(h + att)
        ff = getattr(dec, f"ff2_{i}")(gelu(getattr(dec, f"ff1_{i}")(h)))
        h = getattr(dec, f"ln2_{i}")(h + ff)
    return h


class Dec_TxtTransformer(VaeDecoder):
    """Character-level text transformer decoder: emits (B, T, alphabet),
    zeroing the padded positions."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 ff_size: int = 128, num_layers: int = 1, num_heads: int = 2):
        super().__init__(latent_dim, data_dim, latent_private)
        self.seq_len, vocab = int(self.data_dim[0]), int(self.data_dim[1])
        self.num_layers = num_layers
        # d_model: out_dim rounded up to a multiple of num_heads; at 16
        # latents and 2 heads it is 16, so the cross-attention has Dh = 8
        # and Tk = 1
        self.d_model = math.ceil(self.out_dim / num_heads) * num_heads
        if self.d_model != self.out_dim:
            self.Dense_0 = nn.Linear(self.out_dim, self.d_model)
        _add_time_query_layers(self, self.d_model, num_layers, num_heads, ff_size)
        self.finallayer = nn.Linear(self.d_model, vocab)

    def forward(self, z: torch.Tensor, mask: Optional[torch.Tensor] = None):
        zin = self.Dense_0(z) if self.d_model != z.shape[-1] else z
        out = _time_query_decode(self, zin, self.seq_len, self.d_model,
                                 self.num_layers)
        out = self.finallayer(out).float()
        if mask is not None:
            out = out * mask.to(out.dtype)[..., None]
        return out, self.scale_like(out)


DECODERS = {
    "CNN": Dec_CNN,
    "TxtTransformer": Dec_TxtTransformer,
}


def get_decoder(name: str):
    """Decoder factory by config name; only the slice's decoders so far."""
    if name not in DECODERS:
        raise KeyError(f"Did not find decoder {name}; available: {sorted(DECODERS)}")
    return DECODERS[name]
