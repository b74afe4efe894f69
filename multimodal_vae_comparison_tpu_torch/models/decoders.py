"""Decoders of the ported models (counterpart of ``models/decoders.py``).

Decoders take ``(z, mask)`` with z of shape (B, total_latents) and return
``(mean, scale)`` (decoders that end in ``squash_dist`` also the clipped
logits), with ``scale`` the fixed likelihood scale ``DEC_SCALE``, an fp32 scalar.
Images come out NHWC and videos (B, T, H, W, C).  The nets compute in the
model's compute dtype (``models/precision.py``); as in the reference the
squashed image decoders give their mean and clipped logits in it, and the
sequence, text-deconv, image-sequence and video decoders widen their output
to fp32 first.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_vae_comparison_tpu_torch.constants import DEC_SCALE, ETA
from multimodal_vae_comparison_tpu_torch.models.precision import (
    ConvTranspose1d, ConvTranspose2d, Conv2d, LayerNorm, Linear, widen)
from multimodal_vae_comparison_tpu_torch.models.nets import (
    LN_EPS, AttentionResidualBlock, ConvTranspose2dTorch, GroupNorm,
    MultiHeadAttention, ResUp, SamePadConvTranspose3d, SparseAttentionResidualBlock,
    transpose_crops, gelu, group_norm, positional_encoding, resample_strides)

# logit(1 - ETA): clipping logits to +-this bound == clipping sigmoid(x) to
# [ETA, 1-ETA] (see VaeDecoder.squash_dist)
_LOGIT_BOUND = float(np.log((1.0 - ETA) / ETA))


class VaeDecoder(nn.Module):
    """Base decoder: holds dims."""

    compute_dtype = None

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
        self.Dense_0 = Linear(self.out_dim, hidden_dim)
        self.Dense_1 = Linear(hidden_dim, hidden_dim)
        self.Dense_2 = Linear(hidden_dim, hid_channels * 16)
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
        dec.add_module(f"ln1_{i}", LayerNorm(d_model, eps=LN_EPS))
        dec.add_module(f"ff1_{i}", Linear(d_model, ff_size))
        dec.add_module(f"ff2_{i}", Linear(ff_size, d_model))
        dec.add_module(f"ln2_{i}", LayerNorm(d_model, eps=LN_EPS))


def _time_query_decode(dec: nn.Module, z: torch.Tensor, seq_len: int,
                       d_model: int, num_layers: int,
                       memory: Optional[torch.Tensor] = None,
                       memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Positional time-queries cross-attend to z as a single-token memory;
    no self-attention among the queries (see the reference's docstring).

    ``memory`` (B, Tm, d_model) replaces the one z token (conditioned
    decoding: z and the instruction's tokens) and ``memory_mask`` (B, Tm)
    bool, True = attend, is its key padding: the reference's additive
    (B, 1, 1, Tm) ``memory_bias`` in the form the attention kernel takes."""
    b = z.shape[0]
    h = positional_encoding(seq_len, d_model, device=z.device,
                            dtype=dec.compute_dtype or z.dtype)[None].expand(
                                b, seq_len, d_model)
    if memory is None:
        memory = z[:, None, :]
    for i in range(num_layers):
        att = getattr(dec, f"cross_attn_{i}")(h, memory, memory_mask)
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
            self.Dense_0 = Linear(self.out_dim, self.d_model)
        _add_time_query_layers(self, self.d_model, num_layers, num_heads, ff_size)
        self.finallayer = Linear(self.d_model, vocab)

    def forward(self, z: torch.Tensor, mask: Optional[torch.Tensor] = None):
        zin = self.Dense_0(z) if self.d_model != z.shape[-1] else z
        out = _time_query_decode(self, zin, self.seq_len, self.d_model,
                                 self.num_layers)
        out = widen(self.finallayer(out))
        if mask is not None:
            out = out * mask.to(out.dtype)[..., None]
        return out, self.scale_like(out)


class Dec_Transformer(VaeDecoder):
    """Transformer decoder for arbitrary sequences (VILANRO's action
    trajectories): 4 layers of time-queries cross-attending to z (ff 1024,
    2 heads), a ``finallayer`` to joints x feats a step; emits (B, T,
    joints, feats), or (B, T, joints) for a 2-D ``data_dim``, zeroing the
    padded steps."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 ff_size: int = 1024, num_layers: int = 4, num_heads: int = 2):
        super().__init__(latent_dim, data_dim, latent_private)
        self.seq_len, self.njoints = int(self.data_dim[0]), int(self.data_dim[1])
        self.nfeats = int(self.data_dim[2]) if len(self.data_dim) > 2 else 1
        self.num_layers = num_layers
        self.d_model = math.ceil(self.out_dim / num_heads) * num_heads
        if self.d_model != self.out_dim:
            self.Dense_0 = Linear(self.out_dim, self.d_model)
        _add_time_query_layers(self, self.d_model, num_layers, num_heads, ff_size)
        self.finallayer = Linear(self.d_model, self.njoints * self.nfeats)

    def forward(self, z: torch.Tensor, mask: Optional[torch.Tensor] = None):
        b = z.shape[0]
        zin = self.Dense_0(z) if self.d_model != z.shape[-1] else z
        out = _time_query_decode(self, zin, self.seq_len, self.d_model,
                                 self.num_layers)
        out = widen(self.finallayer(out)).reshape(b, self.seq_len, self.njoints,
                                                  self.nfeats)
        if len(self.data_dim) <= 2:
            out = out.squeeze(-1)
        if mask is not None:
            out = out * mask.to(out.dtype).reshape(b, self.seq_len, *([1] * (out.dim() - 2)))
        return out, self.scale_like(out)


class Dec_TransformerCond(VaeDecoder):
    """Conditioned sequence decoder: Dec_Transformer (4 layers, ff 1024) at
    d_model 128 and 4 heads, whose cross-attention memory holds the z token
    (``z_proj``) and the conditioning modality's tokens (``cond_embed`` of
    the (B, L, vocab) one-hots plus positions), under a key-padding bias
    from ``cond_mask`` that always keeps the z key.  With ``cond=None``
    (the conditioning modality absent) it decodes from the z token alone.
    ``cond_features`` is the width of a conditioning token (the vocabulary);
    without it the decoder has no ``cond_embed`` and takes no ``cond``."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 cond_features: Optional[int] = None, ff_size: int = 1024,
                 num_layers: int = 4, num_heads: int = 4, d_model: int = 128):
        super().__init__(latent_dim, data_dim, latent_private)
        self.seq_len, self.njoints = int(self.data_dim[0]), int(self.data_dim[1])
        self.nfeats = int(self.data_dim[2]) if len(self.data_dim) > 2 else 1
        self.num_layers, self.d_model = num_layers, d_model
        self.z_proj = Linear(self.out_dim, d_model)
        if cond_features is not None:
            self.cond_embed = Linear(cond_features, d_model)
        _add_time_query_layers(self, d_model, num_layers, num_heads, ff_size)
        self.finallayer = Linear(d_model, self.njoints * self.nfeats)

    def forward(self, z: torch.Tensor, mask: Optional[torch.Tensor] = None,
                cond: Optional[torch.Tensor] = None,
                cond_mask: Optional[torch.Tensor] = None):
        b = z.shape[0]
        z_tok = self.z_proj(z)[:, None, :]
        memory, keep = z_tok, None
        if cond is not None:
            ce = self.cond_embed(cond)
            ce = ce + positional_encoding(ce.shape[1], self.d_model, device=ce.device,
                                          dtype=ce.dtype)[None]
            memory = torch.cat([z_tok, ce], dim=1)
            if cond_mask is not None:   # the z key is always kept
                keep = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=z.device),
                                  cond_mask.to(torch.bool)], dim=1)
        out = _time_query_decode(self, z_tok[:, 0], self.seq_len, self.d_model,
                                 self.num_layers, memory=memory, memory_mask=keep)
        out = widen(self.finallayer(out)).reshape(b, self.seq_len, self.njoints,
                                                  self.nfeats)
        if len(self.data_dim) <= 2:
            out = out.squeeze(-1)
        if mask is not None:
            out = out * mask.to(out.dtype).reshape(b, self.seq_len, *([1] * (out.dim() - 2)))
        return out, self.scale_like(out)


class Dec_MNIST(VaeDecoder):
    """2-layer MLP decoder (width 400, relu) to ``data_dim`` (28x28x1),
    squashed as the image decoders are."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hidden_dim: int = 400):
        super().__init__(latent_dim, data_dim, latent_private)
        self.Dense_0 = Linear(self.out_dim, hidden_dim)
        self.Dense_1 = Linear(hidden_dim, hidden_dim)
        self.Dense_2 = Linear(hidden_dim, math.prod(self.data_dim))

    def forward(self, z: torch.Tensor, mask=None):
        h = F.relu(self.Dense_1(F.relu(self.Dense_0(z))))
        return self.squash_dist(self.Dense_2(h), z.shape[0])


class Dec_MNIST2(VaeDecoder):
    """1-layer MLP decoder (width 400, relu) of the MMVAE repository to
    ``data_dim``, squashed as the image decoders are."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hidden_dim: int = 400):
        super().__init__(latent_dim, data_dim, latent_private)
        self.Dense_0 = Linear(self.out_dim, hidden_dim)
        self.Dense_1 = Linear(hidden_dim, math.prod(self.data_dim))

    def forward(self, z: torch.Tensor, mask=None):
        return self.squash_dist(self.Dense_1(F.relu(self.Dense_0(z))), z.shape[0])


def _up_stack(dec: nn.Module, x: torch.Tensor, n: int) -> torch.Tensor:
    """``ConvTranspose2dTorch_0`` .. ``_{n-1}`` on NHWC ``x``, relu after
    each but the last."""
    for i in range(n):
        x = getattr(dec, f"ConvTranspose2dTorch_{i}")(x)
        if i < n - 1:
            x = F.relu(x)
    return x


class Dec_SVHN(VaeDecoder):
    """SVHN decoder to 32x32x3: Dense 128 + relu as a 1x1 map, a 4x4
    unpadded transposed conv to 4x4x64 (flax's ``VALID``), then three 2x
    transposed convs (64, 32, 3; relu between)."""

    def __init__(self, latent_dim, data_dim, latent_private=None):
        super().__init__(latent_dim, data_dim, latent_private)
        self.Dense_0 = Linear(self.out_dim, 128)
        self.ConvTranspose_0 = ConvTranspose2d(128, 64, 4)
        for i, (c_in, c_out) in enumerate(((64, 64), (64, 32), (32, 3))):
            self.add_module(f"ConvTranspose2dTorch_{i}", ConvTranspose2dTorch(c_in, c_out))

    def forward(self, z: torch.Tensor, mask=None):
        b = z.shape[0]
        h = F.relu(self.Dense_0(z)).reshape(b, 128, 1, 1)
        h = F.relu(self.ConvTranspose_0(h)).permute(0, 2, 3, 1)
        return self.squash_dist(_up_stack(self, h, 3), b)


class Dec_SVHN2(VaeDecoder):
    """SVHN decoder of the MMVAE repository: z as a 1x1 map, a 4x4 unpadded
    transposed conv to 4x4 x fBase*4 (flax's ``VALID``), then three 2x
    transposed convs (fBase*2, fBase, 3; relu between) to 32x32x3."""

    def __init__(self, latent_dim, data_dim, latent_private=None, fBase: int = 32):
        super().__init__(latent_dim, data_dim, latent_private)
        self.ConvTranspose_0 = ConvTranspose2d(self.out_dim, fBase * 4, 4)
        for i, (c_in, c_out) in enumerate(((fBase * 4, fBase * 2), (fBase * 2, fBase),
                                           (fBase, 3))):
            self.add_module(f"ConvTranspose2dTorch_{i}", ConvTranspose2dTorch(c_in, c_out))

    def forward(self, z: torch.Tensor, mask=None):
        b = z.shape[0]
        h = F.relu(self.ConvTranspose_0(z.reshape(b, -1, 1, 1))).permute(0, 2, 3, 1)
        return self.squash_dist(_up_stack(self, h, 3), b)


class Dec_PolyMNIST(VaeDecoder):
    """PolyMNIST deconv decoder (MVTCAE): Dense 2048 + relu as a 4x4x128 map,
    three 3x3 stride-2 transposed convs with flax's ``SAME`` padding (64,
    32, 3; relu between) to 32x32, cropped to the centre 28x28.

    Flax's ``SAME`` transposed conv at kernel 3, stride 2 is PyTorch's
    unpadded one (on the flipped kernel, which the bridge flips) with its
    last row and column cut: 2n + 1 -> 2n."""

    def __init__(self, latent_dim, data_dim, latent_private=None):
        super().__init__(latent_dim, data_dim, latent_private)
        self.Dense_0 = Linear(self.out_dim, 2048)
        for i, (c_in, c_out) in enumerate(((128, 64), (64, 32), (32, 3))):
            self.add_module(f"ConvTranspose_{i}", ConvTranspose2d(c_in, c_out, 3, stride=2))
        self.crop = transpose_crops(3, 2)

    def forward(self, z: torch.Tensor, mask=None):
        b = z.shape[0]
        # NHWC (b, 4, 4, 128), as the reference reshapes, viewed as NCHW
        h = F.relu(self.Dense_0(z)).reshape(b, 4, 4, 128).permute(0, 3, 1, 2)
        lo, hi = self.crop
        for i in range(3):
            h = getattr(self, f"ConvTranspose_{i}")(h)
            h = h[:, :, lo:h.shape[2] - hi, lo:h.shape[3] - hi]
            if i < 2:
                h = F.relu(h)
        # 4 -> 8 -> 16 -> 32, the centre 28x28
        return self.squash_dist(h[:, :, 2:30, 2:30].permute(0, 2, 3, 1), b)


class Dec_RESCNN(VaeDecoder):
    """Residual up-sampling decoder: Dense to a 4x4 x 16``ch`` map (NHWC, as
    the reference reshapes), four ``ResUp`` blocks (8, 4, 2 and 1 x ``ch``;
    4 -> 64 px), a 3x3 conv to 3 channels, squashed as the image decoders
    are."""

    def __init__(self, latent_dim, data_dim, latent_private=None, ch: int = 64):
        super().__init__(latent_dim, data_dim, latent_private)
        self.ch = ch
        self.Dense_0 = Linear(self.out_dim, 16 * ch * 16)
        c = 16 * ch
        for i, mult in enumerate((8, 4, 2, 1)):
            self.add_module(f"ResUp_{i}", ResUp(c, ch * mult))
            c = ch * mult
        self.Conv_0 = Conv2d(ch, 3, 3, padding=1)

    def forward(self, z: torch.Tensor, mask=None):
        b = z.shape[0]
        h = self.Dense_0(z).reshape(b, 4, 4, 16 * self.ch).permute(0, 3, 1, 2)
        for i in range(4):
            h = getattr(self, f"ResUp_{i}")(h)
        return self.squash_dist(self.Conv_0(h).permute(0, 2, 3, 1), b)


class Dec_ConvTxt(VaeDecoder):
    """Deconvolutional text decoder: Dense to (seq // 8, 3 fBase), three 1-D
    transposed convs (k 3, stride 2, flax's ``SAME``: PyTorch's unpadded one
    cut by ``transpose_crops``; 3, 2 and 1 x fBase channels) each followed
    by GroupNorm and ReLU, the (B, T', C) flatten, ``toVocabSize`` to seq x
    vocab, and a sigmoid."""

    def __init__(self, latent_dim, data_dim, latent_private=None, fBase: int = 64):
        super().__init__(latent_dim, data_dim, latent_private)
        self.seq_len, self.vocab = int(self.data_dim[0]), int(self.data_dim[1])
        self.start, self.width = max(self.seq_len // 8, 1), fBase * 3
        self.Dense_0 = Linear(self.out_dim, self.start * self.width)
        c = self.width
        for i, feat in enumerate((fBase * 3, fBase * 2, fBase)):
            self.add_module(f"ConvTranspose_{i}", ConvTranspose1d(c, feat, 3, stride=2))
            self.add_module(f"GroupNorm_{i}", group_norm(feat))
            c = feat
        self.crop = transpose_crops(3, 2)
        self.toVocabSize = Linear(self.start * 8 * fBase, self.seq_len * self.vocab)

    def forward(self, z: torch.Tensor, mask=None):
        b = z.shape[0]
        h = self.Dense_0(z).reshape(b, self.start, self.width).transpose(1, 2)  # (B, C, T)
        lo, hi = self.crop
        for i in range(3):
            h = getattr(self, f"ConvTranspose_{i}")(h)
            h = F.relu(getattr(self, f"GroupNorm_{i}")(h[:, :, lo:h.shape[2] - hi]))
        out = self.toVocabSize(h.transpose(1, 2).reshape(b, -1))
        mean = torch.sigmoid(widen(out)).reshape(b, self.seq_len, self.vocab)
        return mean, self.scale_like(mean)


class Dec_TransformerIMG(VaeDecoder):
    """Image-sequence decoder to (B, T, 64, 64, 3): Dense to d_model 256,
    time-queries cross-attending to the z token (4 layers, 4 heads, ff 1024;
    Dh 64, one key), ``Dense`` to a 4x4 x ``hid_channels`` map per frame,
    three 2x transposed convs with SiLU and a last one to 3 channels, and a
    sigmoid."""

    def __init__(self, latent_dim, data_dim, latent_private=None, ff_size: int = 1024,
                 num_layers: int = 4, num_heads: int = 4, hid_channels: int = 64,
                 d_model: int = 256):
        super().__init__(latent_dim, data_dim, latent_private)
        self.seq_len, self.num_layers = int(self.data_dim[0]), num_layers
        self.d_model, self.hid_channels = d_model, hid_channels
        self.Dense_0 = Linear(self.out_dim, d_model)
        _add_time_query_layers(self, d_model, num_layers, num_heads, ff_size)
        self.Dense_1 = Linear(d_model, hid_channels * 16)
        for i in range(4):
            self.add_module(f"ConvTranspose2dTorch_{i}", ConvTranspose2dTorch(
                hid_channels, 3 if i == 3 else hid_channels))

    def forward(self, z: torch.Tensor, mask=None):
        b = z.shape[0]
        out = _time_query_decode(self, self.Dense_0(z), self.seq_len, self.d_model,
                                 self.num_layers)
        h = self.Dense_1(out).reshape(b * self.seq_len, 4, 4, self.hid_channels)
        for i in range(4):
            h = getattr(self, f"ConvTranspose2dTorch_{i}")(h)
            if i < 3:
                h = F.silu(h)
        mean = torch.sigmoid(widen(h)).reshape(b, self.seq_len, *self.data_dim[1:])
        return mean, self.scale_like(mean)


class Dec_FNN(VaeDecoder):
    """Generic MLP decoder."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hidden_dim: int = 128):
        super().__init__(latent_dim, data_dim, latent_private)
        self.Dense_0 = Linear(self.out_dim, hidden_dim)
        self.Dense_1 = Linear(hidden_dim, math.prod(self.data_dim))

    def forward(self, z: torch.Tensor, mask=None):
        return self.squash_dist(self.Dense_1(F.relu(self.Dense_0(z))), z.shape[0])


class Dec_VideoGPT(VaeDecoder):
    """VideoGPT-style video decoder: a linear seed of (T, H/u, W/u, hidden),
    attention-residual blocks (axial, or strided block-sparse with
    ``attn_type="sparse"``), norm, transposed same-pad convs up to
    (B, T, H, W, 3).  Returns probabilities (a sigmoid), not logits."""

    attn_type = "axial"

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 n_res_layers: int = 4, upsample: Sequence[int] = (1, 4, 4),
                 hidden: int = 64):
        super().__init__(latent_dim, data_dim, latent_private)
        self.n_res_layers, self.hidden = n_res_layers, hidden
        self.frames = int(self.data_dim[0])
        self.base = int(self.data_dim[1]) // int(upsample[1])
        self.upsample_lin = Linear(
            self.out_dim, hidden * self.frames * self.base * self.base)
        block_cls = (SparseAttentionResidualBlock if self.attn_type == "sparse"
                     else AttentionResidualBlock)
        self.block_name = block_cls.__name__
        for i in range(n_res_layers):
            self.add_module(f"{self.block_name}_{i}", block_cls(hidden))
        self.GroupNorm_0 = GroupNorm(hidden)
        all_strides = resample_strides(upsample)
        self.n_up = len(all_strides)
        for i, strides in enumerate(all_strides):
            self.add_module(f"SamePadConvTranspose3d_{i}", SamePadConvTranspose3d(
                hidden, 3 if i == self.n_up - 1 else hidden, kernel=4, strides=strides))

    def forward(self, z: torch.Tensor, mask=None):
        h = self.upsample_lin(z).reshape(z.shape[0], self.frames, self.base,
                                         self.base, self.hidden)
        for i in range(self.n_res_layers):
            h = getattr(self, f"{self.block_name}_{i}")(h)
        h = F.relu(self.GroupNorm_0(h))
        for i in range(self.n_up):
            h = getattr(self, f"SamePadConvTranspose3d_{i}")(h)
            if i < self.n_up - 1:
                h = F.relu(h)
        mean = torch.sigmoid(widen(h))
        return mean, self.scale_like(mean)


class Dec_VideoGPTSparse(Dec_VideoGPT):
    """Dec_VideoGPT with strided block-sparse attention over the flattened
    spacetime tokens."""

    attn_type = "sparse"


DECODERS = {
    "CNN": Dec_CNN,
    "FNN": Dec_FNN,
    "MNIST": Dec_MNIST,
    "MNIST2": Dec_MNIST2,
    "PolyMNIST": Dec_PolyMNIST,
    "RESCNN": Dec_RESCNN,
    "SVHN": Dec_SVHN,
    "SVHN2": Dec_SVHN2,
    "Transformer": Dec_Transformer,
    "TransformerCond": Dec_TransformerCond,
    "TxtTransformer": Dec_TxtTransformer,
    "ConvTxt": Dec_ConvTxt,
    "TransformerIMG": Dec_TransformerIMG,
    "VideoGPT": Dec_VideoGPT,
    "VideoGPTSparse": Dec_VideoGPTSparse,
}


def get_decoder(name: str):
    """Decoder factory by config name (every decoder of the reference)."""
    if name not in DECODERS:
        raise KeyError(f"Did not find decoder {name}; available: {sorted(DECODERS)}")
    return DECODERS[name]
