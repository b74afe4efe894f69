"""Encoders on the serving slice's path (counterpart of ``models/encoders.py``).

Encoders take ``(data, mask)`` and return ``(mu, scale)`` of shape
(B, out_dim), with ``scale = softmax(raw) + ETA`` computed in fp32.  Images
are NHWC, as in the reference.  PyTorch needs every layer's input width at
construction, so each encoder derives it from ``data_dim``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_vae_comparison_tpu_torch.constants import ETA
from multimodal_vae_comparison_tpu_torch.models.nets import (
    TransformerEncoder, positional_encoding)


class VaeEncoder(nn.Module):
    """Base encoder: holds dims and the (mu, scale) head convention."""

    def __init__(self, latent_dim: int, data_dim: Sequence[int],
                 latent_private: Optional[int] = None):
        super().__init__()
        self.latent_dim = latent_dim
        self.data_dim = tuple(data_dim)
        self.latent_private = latent_private

    @property
    def out_dim(self) -> int:
        return self.latent_dim + (self.latent_private or 0)

    def _add_head(self, hidden: int) -> None:
        self.mu_layer = nn.Linear(hidden, self.out_dim)
        self.logvar_layer = nn.Linear(hidden, self.out_dim)

    def head(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """mu/scale head with the reference's softmax+eta scale activation."""
        mu = self.mu_layer(h)
        raw = self.logvar_layer(h)
        scale = torch.softmax(raw.float(), dim=-1) + ETA
        return mu.float(), scale


class Enc_CNN2(VaeEncoder):
    """Classic 4-layer conv VAE encoder for NHWC images."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hid_channels: int = 32, hidden_dim: int = 512):
        super().__init__(latent_dim, data_dim, latent_private)
        h, w, c = self.data_dim[0], self.data_dim[1], self.data_dim[-1]
        for i in range(4):
            self.add_module(f"Conv_{i}", nn.Conv2d(c, hid_channels, 4,
                                                   stride=2, padding=1))
            c = hid_channels
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
        self.Dense_0 = nn.Linear(hid_channels * h * w, hidden_dim)
        self._add_head(hidden_dim)

    def forward(self, data: torch.Tensor, mask=None):
        h = data.permute(0, 3, 1, 2)          # NHWC -> NCHW view
        for i in range(4):
            h = F.silu(getattr(self, f"Conv_{i}")(h))
        # flatten in NHWC order, as the reference's Dense expects
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.head(self.Dense_0(h))


class Enc_TxtTransformer(VaeEncoder):
    """Character-level text transformer encoder on one-hot input: embedding
    matmul, positional encoding, post-norm encoder, masked mean pool."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 ff_size: int = 128, num_layers: int = 1, num_heads: int = 2,
                 d_model: int = 64):
        super().__init__(latent_dim, data_dim, latent_private)
        self.d_model = d_model
        self.embedding = nn.Linear(math.prod(self.data_dim[1:]), d_model)
        self.TransformerEncoder_0 = TransformerEncoder(num_layers, d_model,
                                                       num_heads, ff_size)
        self._add_head(d_model)

    def forward(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None):
        b, t = data.shape[0], data.shape[1]
        x = self.embedding(data.reshape(b, t, -1))
        x = x + positional_encoding(t, self.d_model, device=x.device,
                                    dtype=x.dtype)[None]
        h = self.TransformerEncoder_0(x, key_mask=mask)
        if mask is not None:
            m = mask.to(h.dtype)[..., None]
            h = (h * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        else:
            h = h.mean(dim=1)
        return self.head(h)


ENCODERS = {
    "CNN2": Enc_CNN2,
    "TxtTransformer": Enc_TxtTransformer,
}


def get_encoder(name: str):
    """Encoder factory by config name; only the slice's encoders so far."""
    if name not in ENCODERS:
        raise KeyError(f"Did not find encoder {name}; available: {sorted(ENCODERS)}")
    return ENCODERS[name]
