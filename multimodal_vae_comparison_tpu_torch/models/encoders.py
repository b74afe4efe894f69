"""Encoders of the ported models (counterpart of ``models/encoders.py``).

Encoders take ``(data, mask)`` and return ``(mu, scale)`` of shape
(B, out_dim), with ``scale = softmax(raw) + ETA``.  The nets compute in the
model's compute dtype (``models/precision.py``); the posterior leaves every
encoder in fp32 (fp64 under ``model.double()``), as the reference's does.  Images
are NHWC and videos (B, T, H, W, C), as in the reference.  PyTorch needs every layer's input width at
construction, so each encoder derives it from ``data_dim``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_vae_comparison_tpu_torch.constants import ETA
from multimodal_vae_comparison_tpu_torch.models.init import flax_gru_
from multimodal_vae_comparison_tpu_torch.models.precision import (
    Conv1d, Conv2d, Linear, widen)
from multimodal_vae_comparison_tpu_torch.models.nets import (
    AttentionResidualBlock, GroupNorm, ResDown, ResNet50, SamePadConv3d,
    SparseAttentionResidualBlock, TransformerEncoder, ViT, group_norm,
    positional_encoding, resample_strides)


class VaeEncoder(nn.Module):
    """Base encoder: holds dims and the (mu, scale) head convention."""

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

    def _add_head(self, hidden: int) -> None:
        self.mu_layer = Linear(hidden, self.out_dim)
        self.logvar_layer = Linear(hidden, self.out_dim)

    def head(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """mu/scale head with the reference's softmax+eta scale activation."""
        mu = self.mu_layer(h)
        raw = self.logvar_layer(h)
        scale = torch.softmax(widen(raw), dim=-1) + ETA
        return widen(mu), scale


class Enc_CNN(VaeEncoder):
    """ResNet-50 trunk + SiLU + the (mu, scale) head for NHWC images.  The
    trunk starts from random init: the reference's ImageNet weights are
    not in the repository."""

    def __init__(self, latent_dim, data_dim, latent_private=None):
        super().__init__(latent_dim, data_dim, latent_private)
        self.ResNet50_0 = ResNet50(in_channels=int(self.data_dim[-1]), num_outputs=1000)
        self._add_head(1000)

    def forward(self, data: torch.Tensor, mask=None):
        return self.head(F.silu(self.ResNet50_0(data)))


class Enc_VIT(VaeEncoder):
    """ViT trunk (width 256, depth 6, 8 heads, 1000 outputs) + SiLU + the
    (mu, scale) head for NHWC images."""

    def __init__(self, latent_dim, data_dim, latent_private=None):
        super().__init__(latent_dim, data_dim, latent_private)
        self.ViT_0 = ViT(self.data_dim[:2], in_channels=int(self.data_dim[-1]),
                         num_outputs=1000)
        self._add_head(1000)

    def forward(self, data: torch.Tensor, mask=None):
        return self.head(F.silu(self.ViT_0(data)))


class Enc_CNN2(VaeEncoder):
    """Classic 4-layer conv VAE encoder for NHWC images."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hid_channels: int = 32, hidden_dim: int = 512):
        super().__init__(latent_dim, data_dim, latent_private)
        h, w, c = self.data_dim[0], self.data_dim[1], self.data_dim[-1]
        for i in range(4):
            self.add_module(f"Conv_{i}", Conv2d(c, hid_channels, 4,
                                                   stride=2, padding=1))
            c = hid_channels
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
        self.Dense_0 = Linear(hid_channels * h * w, hidden_dim)
        self._add_head(hidden_dim)

    def forward(self, data: torch.Tensor, mask=None):
        h = data.permute(0, 3, 1, 2)          # NHWC -> NCHW view
        for i in range(4):
            h = F.silu(getattr(self, f"Conv_{i}")(h))
        # flatten in NHWC order, as the reference's Dense expects
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.head(self.Dense_0(h))


def _coords(h: int, w: int, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ys (h,), xs (w,)): ``linspace(-1, 1)`` over each spatial axis."""
    return (torch.linspace(-1.0, 1.0, h, device=like.device, dtype=like.dtype),
            torch.linspace(-1.0, 1.0, w, device=like.device, dtype=like.dtype))


def _append_coords(h: torch.Tensor) -> torch.Tensor:
    """Concatenate the normalized y and x coordinate channels (CoordConv,
    Liu et al. 2018) after the channels of an NCHW feature map: the order of
    the reference's NHWC concatenation, so a conv kernel's input channels
    line up with the reference's."""
    b, _, hh, ww = h.shape
    ys, xs = _coords(hh, ww, h)
    coords = torch.stack([ys[:, None].expand(hh, ww), xs[None, :].expand(hh, ww)])
    return torch.cat([h, coords[None].expand(b, 2, hh, ww)], dim=1)


class Enc_CNNCoord(VaeEncoder):
    """Enc_CNN2 with the y and x coordinate channels appended before each of
    its 4 stride-2 convs (CoordConv), so each conv takes C + 2 channels:
    position becomes an input feature (VILANRO's image encoder since
    ``vilanro_r3_way_p2c``)."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hid_channels: int = 32, hidden_dim: int = 512):
        super().__init__(latent_dim, data_dim, latent_private)
        h, w, c = self.data_dim[0], self.data_dim[1], self.data_dim[-1]
        for i in range(4):
            self.add_module(f"Conv_{i}", Conv2d(c + 2, hid_channels, 4,
                                                   stride=2, padding=1))
            c = hid_channels
            h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
        self.Dense_0 = Linear(hid_channels * h * w, hidden_dim)
        self._add_head(hidden_dim)

    def forward(self, data: torch.Tensor, mask=None):
        h = data.permute(0, 3, 1, 2)
        for i in range(4):
            h = F.silu(getattr(self, f"Conv_{i}")(_append_coords(h)))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.head(self.Dense_0(h))


class Enc_CNNSpatial(VaeEncoder):
    """Conv trunk with a spatial-softmax (soft-argmax) keypoint head
    (Levine et al. 2016): 3 stride-2 convs, a 3x3 conv to ``n_maps`` maps,
    a softmax over the positions of each map (in fp32 or wider, its logits
    scaled by the learned ``exp(ss_log_temp)``), each map's expected x and
    y and its mean activation in the order ``[kx, ky, presence]``, then
    Dense + silu and the head.  At 64 px the maps are 8x8, at 128 px
    16x16."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hid_channels: int = 32, n_maps: int = 32, hidden_dim: int = 256):
        super().__init__(latent_dim, data_dim, latent_private)
        c = self.data_dim[-1]
        for i in range(3):
            self.add_module(f"Conv_{i}", Conv2d(c, hid_channels, 4, stride=2, padding=1))
            c = hid_channels
        self.add_module("Conv_3", Conv2d(hid_channels, n_maps, 3, padding=1))
        self.ss_log_temp = nn.Parameter(torch.zeros(1))
        self.Dense_0 = Linear(3 * n_maps, hidden_dim)
        self._add_head(hidden_dim)

    def forward(self, data: torch.Tensor, mask=None):
        h = data.permute(0, 3, 1, 2)
        for i in range(3):
            h = F.silu(getattr(self, f"Conv_{i}")(h))
        h = self.Conv_3(h)                                   # (B, C, H, W)
        b, c, hh, ww = h.shape
        hf = h.to(torch.promote_types(h.dtype, torch.float32))   # fp32 at least
        logits = (hf * torch.exp(self.ss_log_temp.to(hf.dtype))).reshape(b, c, hh * ww)
        attn = torch.softmax(logits, dim=-1).reshape(b, c, hh, ww)
        ys, xs = _coords(hh, ww, hf)
        ky = (attn * ys[:, None]).sum(dim=(2, 3))             # (B, C) expected y
        kx = (attn * xs[None, :]).sum(dim=(2, 3))             # (B, C) expected x
        presence = hf.mean(dim=(2, 3))
        feats = torch.cat([kx, ky, presence], dim=-1).to(h.dtype)
        return self.head(F.silu(self.Dense_0(feats)))


class Enc_MNIST(VaeEncoder):
    """2-layer MLP encoder (width 400, relu) on the NHWC flatten of a
    28x28x1 image."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hidden_dim: int = 400):
        super().__init__(latent_dim, data_dim, latent_private)
        self.Dense_0 = Linear(math.prod(self.data_dim), hidden_dim)
        self.Dense_1 = Linear(hidden_dim, hidden_dim)
        self._add_head(hidden_dim)

    def forward(self, data: torch.Tensor, mask=None):
        h = F.relu(self.Dense_0(data.reshape(data.shape[0], -1)))
        return self.head(F.relu(self.Dense_1(h)))


def _scaled_softmax(raw: torch.Tensor) -> torch.Tensor:
    """The MMVAE repository's scale activation, ``softmax(raw) * D + ETA``,
    in fp32 or wider."""
    return torch.softmax(widen(raw), dim=-1) * raw.shape[-1] + ETA


class Enc_MNISTMoE(VaeEncoder):
    """1-layer MLP encoder (width 400, relu) of the MMVAE repository on the
    NHWC flatten of an image; its scale is ``softmax(raw) * D + ETA``."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hidden_dim: int = 400):
        super().__init__(latent_dim, data_dim, latent_private)
        self.Dense_0 = Linear(math.prod(self.data_dim), hidden_dim)
        self.Dense_1 = Linear(hidden_dim, self.out_dim)
        self.Dense_2 = Linear(hidden_dim, self.out_dim)

    def forward(self, data: torch.Tensor, mask=None):
        h = F.relu(self.Dense_0(data.reshape(data.shape[0], -1)))
        return widen(self.Dense_1(h)), _scaled_softmax(self.Dense_2(h))


def _add_convs(enc: nn.Module, specs, c: int, h: int, w: int, kernel: int, stride: int):
    """Register ``Conv_i`` for each (features, padding) of ``specs`` on an
    (h, w, c) input; returns the (h, w, c) of the last one's output."""
    for i, (feat, pad) in enumerate(specs):
        enc.add_module(f"Conv_{i}", Conv2d(c, feat, kernel, stride=stride, padding=pad))
        c = feat
        h, w = (h + 2 * pad - kernel) // stride + 1, (w + 2 * pad - kernel) // stride + 1
    return h, w, c


def _relu_convs(enc: nn.Module, data: torch.Tensor, n: int) -> torch.Tensor:
    """``Conv_0`` .. ``Conv_{n-1}`` each followed by relu, on NHWC ``data``;
    the output is NCHW."""
    h = data.permute(0, 3, 1, 2)
    for i in range(n):
        h = F.relu(getattr(enc, f"Conv_{i}")(h))
    return h


def _flatten_nhwc(h: torch.Tensor) -> torch.Tensor:
    """Flatten an NCHW feature map in NHWC order, as the reference's Dense
    reads it."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


class Enc_PolyMNIST(VaeEncoder):
    """PolyMNIST conv encoder (MVTCAE): three 3x3 stride-2 convs (32, 64,
    128; relu) on a 28x28x3 image, Dense 400 + relu, and mu and raw-scale
    Dense layers with the scale ``softmax(raw) * D + ETA``."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hidden_dim: int = 400):
        super().__init__(latent_dim, data_dim, latent_private)
        h, w, c = _add_convs(self, ((32, 1), (64, 1), (128, 1)), int(self.data_dim[-1]),
                             int(self.data_dim[0]), int(self.data_dim[1]), 3, 2)
        self.Dense_0 = Linear(h * w * c, hidden_dim)
        self.Dense_1 = Linear(hidden_dim, self.out_dim)
        self.Dense_2 = Linear(hidden_dim, self.out_dim)

    def forward(self, data: torch.Tensor, mask=None):
        h = F.relu(self.Dense_0(_flatten_nhwc(_relu_convs(self, data, 3))))
        return widen(self.Dense_1(h)), _scaled_softmax(self.Dense_2(h))


class Enc_SVHN(VaeEncoder):
    """SVHN conv encoder: four 4x4 stride-2 convs (32, 64, 64 padded by 1;
    128 unpadded; relu) from 32x32x3 to 1x1x128, then the head."""

    def __init__(self, latent_dim, data_dim, latent_private=None):
        super().__init__(latent_dim, data_dim, latent_private)
        h, w, c = _add_convs(self, ((32, 1), (64, 1), (64, 1), (128, 0)),
                             int(self.data_dim[-1]), int(self.data_dim[0]),
                             int(self.data_dim[1]), 4, 2)
        self._add_head(h * w * c)

    def forward(self, data: torch.Tensor, mask=None):
        return self.head(_flatten_nhwc(_relu_convs(self, data, 4)))


class Enc_SVHN2(VaeEncoder):
    """SVHN encoder of the MMVAE repository: three 4x4 stride-2 convs
    (fBase x 1, 2, 4; relu) from 32x32 to 4x4, then two 4x4 unpadded convs
    to 1x1 for mu and the raw scale, ``softmax(raw) * D + ETA``."""

    def __init__(self, latent_dim, data_dim, latent_private=None, fBase: int = 32):
        super().__init__(latent_dim, data_dim, latent_private)
        _, _, c = _add_convs(self, ((fBase, 1), (fBase * 2, 1), (fBase * 4, 1)),
                             int(self.data_dim[-1]), int(self.data_dim[0]),
                             int(self.data_dim[1]), 4, 2)
        self.Conv_3 = Conv2d(c, self.out_dim, 4)
        self.Conv_4 = Conv2d(c, self.out_dim, 4)

    def forward(self, data: torch.Tensor, mask=None):
        h = _relu_convs(self, data, 3)
        mu = widen(_flatten_nhwc(self.Conv_3(h)))
        return mu, _scaled_softmax(_flatten_nhwc(self.Conv_4(h)))


class Enc_RESCNN(VaeEncoder):
    """Fully convolutional residual encoder: a 7x7 conv (``ch``) + ELU, four
    ``ResDown`` blocks (2, 4, 8 and 16 x ``ch``; 64 px -> 4x4x1024), the
    NHWC flatten, and the head."""

    def __init__(self, latent_dim, data_dim, latent_private=None, ch: int = 64):
        super().__init__(latent_dim, data_dim, latent_private)
        h, w = int(self.data_dim[0]), int(self.data_dim[1])
        self.Conv_0 = Conv2d(int(self.data_dim[-1]), ch, 7, padding=3)
        c = ch
        for i, mult in enumerate((2, 4, 8, 16)):
            self.add_module(f"ResDown_{i}", ResDown(c, ch * mult))
            c, h, w = ch * mult, (h - 1) // 2 + 1, (w - 1) // 2 + 1
        self._add_head(h * w * c)

    def forward(self, data: torch.Tensor, mask=None):
        h = F.elu(self.Conv_0(data.permute(0, 3, 1, 2)))
        for i in range(4):
            h = getattr(self, f"ResDown_{i}")(h)
        return self.head(_flatten_nhwc(h))


def _encode_sequence(embedding: nn.Module, encoder: nn.Module, d_model: int,
                     data: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-step embedding, sinusoidal positions, the masked post-norm
    encoder, and a mean pool over the valid steps (every step unmasked)."""
    b, t = data.shape[0], data.shape[1]
    x = embedding(data.reshape(b, t, -1))
    x = x + positional_encoding(t, d_model, device=x.device, dtype=x.dtype)[None]
    h = encoder(x, key_mask=mask)
    if mask is None:
        return h.mean(dim=1)
    m = mask.to(h.dtype)[..., None]
    return (h * m).sum(1) / torch.clamp(m.sum(1), min=1.0)


class Enc_TxtTransformer(VaeEncoder):
    """Character-level text transformer encoder on one-hot input: embedding
    matmul, positional encoding, post-norm encoder, masked mean pool."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 ff_size: int = 128, num_layers: int = 1, num_heads: int = 2,
                 d_model: int = 64):
        super().__init__(latent_dim, data_dim, latent_private)
        self.d_model = d_model
        self.embedding = Linear(math.prod(self.data_dim[1:]), d_model)
        self.TransformerEncoder_0 = TransformerEncoder(num_layers, d_model,
                                                       num_heads, ff_size)
        self._add_head(d_model)

    def forward(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None):
        return self.head(_encode_sequence(self.embedding, self.TransformerEncoder_0,
                                          self.d_model, data, mask))


class Enc_Transformer(VaeEncoder):
    """ACTOR-style transformer encoder for arbitrary sequences (VILANRO's
    action trajectories, (B, T, ...) flattened per step): a per-step linear
    ``skel_embedding`` to d_model (the latent width rounded down to a
    multiple of the heads), positional encoding, 8 masked post-norm layers
    (ff 1024, 2 heads), masked mean pool."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 ff_size: int = 1024, num_layers: int = 8, num_heads: int = 2):
        super().__init__(latent_dim, data_dim, latent_private)
        self.d_model = max(num_heads, self.out_dim - self.out_dim % num_heads)
        self.skel_embedding = Linear(math.prod(self.data_dim[1:]), self.d_model)
        self.TransformerEncoder_0 = TransformerEncoder(num_layers, self.d_model,
                                                       num_heads, ff_size)
        self._add_head(self.d_model)

    def forward(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None):
        return self.head(_encode_sequence(self.skel_embedding, self.TransformerEncoder_0,
                                          self.d_model, data, mask))


class Enc_ConvTxt(VaeEncoder):
    """Convolutional text encoder: a per-character ``embedding`` Dense, then
    three 1-D convs (k 3, stride 2, padding 1, no bias; fBase x 1, 2, 3
    channels), each followed by GroupNorm and ReLU, the (B, T', C) flatten,
    and the head."""

    def __init__(self, latent_dim, data_dim, latent_private=None, fBase: int = 32,
                 embed_dim: int = 32):
        super().__init__(latent_dim, data_dim, latent_private)
        self.embedding = Linear(math.prod(self.data_dim[1:]), embed_dim)
        c, t = embed_dim, int(self.data_dim[0])
        for i, feat in enumerate((fBase, fBase * 2, fBase * 3)):
            self.add_module(f"Conv_{i}", Conv1d(c, feat, 3, stride=2, padding=1,
                                                   bias=False))
            self.add_module(f"GroupNorm_{i}", group_norm(feat))
            c, t = feat, (t - 1) // 2 + 1
        self._add_head(t * c)

    def forward(self, data: torch.Tensor, mask=None):
        b, t = data.shape[0], data.shape[1]
        x = self.embedding(data.reshape(b, t, -1)).transpose(1, 2)   # (B, C, T)
        for i in range(3):
            x = F.relu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
        return self.head(x.transpose(1, 2).reshape(b, -1))


class Enc_TxtRNN(VaeEncoder):
    """Bidirectional GRU text encoder: a per-character ``embed`` Dense to
    ``hidden_size``, a forward GRU (``GRUCell_0``) and a backward one
    (``GRUCell_1``) whose final states at each row's true end are summed,
    and ``o2p`` to (mu, raw) with ``scale = softmax(raw) + ETA``.

    A row's length is its mask's count of valid steps (the full length
    without a mask; at least 1).  The forward state is the GRU's output at
    step length - 1; the backward one runs over the row's valid prefix
    reversed, the padding left after it, and is read at the same step: the
    reference's ``nn.RNN(..., seq_lengths=, reverse=True)``, with no host
    sync for the lengths.

    Each GRU is PyTorch's (cuDNN's on the card) in flax's ``GRUCell`` form,
    drawn as flax draws the cell (``init.flax_gru_``): the hidden-side
    reset and update gates have no bias in flax, so those two thirds of
    ``bias_hh_l0`` start at 0 and their gradient is held at 0.  The GRUs
    run in fp32 under any compute dtype (the reference builds its cells
    without one: flax promotes the bf16 embedding to their fp32
    parameters)."""

    def __init__(self, latent_dim, data_dim, latent_private=None, hidden_size: int = 512):
        super().__init__(latent_dim, data_dim, latent_private)
        self.hidden_size = hidden_size
        self.embed = Linear(math.prod(self.data_dim[1:]), hidden_size)
        for i in range(2):
            gru = nn.GRU(hidden_size, hidden_size, batch_first=True)
            flax_gru_(gru)
            keep = torch.ones(3 * hidden_size)
            keep[: 2 * hidden_size] = 0.0
            gru.bias_hh_l0.register_hook(lambda g, keep=keep: g * keep.to(g.device, g.dtype))
            self.add_module(f"GRUCell_{i}", gru)
        self.o2p = Linear(hidden_size, 2 * self.out_dim)

    def forward(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None):
        b, t = data.shape[0], data.shape[1]
        x = widen(self.embed(data.reshape(b, t, -1)))
        steps = torch.arange(t, device=x.device)
        if mask is None:
            lengths = torch.full((b,), t, device=x.device)
        else:
            lengths = mask.reshape(b, t).sum(-1).clamp(min=1)
        last = (lengths - 1)[:, None, None].expand(b, 1, self.hidden_size)
        # each row's valid prefix reversed, its padding kept after it
        rev = torch.where(steps[None] < lengths[:, None], lengths[:, None] - 1 - steps[None],
                          steps[None])
        x_rev = x.gather(1, rev[..., None].expand(b, t, x.shape[-1]))
        fwd = self.GRUCell_0(x)[0].gather(1, last)[:, 0]
        bwd = self.GRUCell_1(x_rev)[0].gather(1, last)[:, 0]
        mu, raw = self.o2p(fwd + bwd).chunk(2, dim=-1)
        return widen(mu), torch.softmax(widen(raw), dim=-1) + ETA


class Enc_TransformerIMG(VaeEncoder):
    """Image-sequence encoder on (B, T, H, W, C): four 4x4 stride-2 convs
    (``hid_channels``, SiLU) per frame, the NHWC flatten, ``Dense`` to 256,
    positional encoding, a 4-layer 4-head post-norm encoder (ff 1024; Dh
    64) under the frame mask, the masked mean over frames, and the head."""

    def __init__(self, latent_dim, data_dim, latent_private=None, ff_size: int = 1024,
                 num_layers: int = 4, num_heads: int = 4, hid_channels: int = 64,
                 d_model: int = 256):
        super().__init__(latent_dim, data_dim, latent_private)
        self.d_model = d_model
        h, w, c = _add_convs(self, ((hid_channels, 1),) * 4, int(self.data_dim[-1]),
                             int(self.data_dim[1]), int(self.data_dim[2]), 4, 2)
        self.Dense_0 = Linear(h * w * c, d_model)
        self.TransformerEncoder_0 = TransformerEncoder(num_layers, d_model, num_heads,
                                                       ff_size)
        self._add_head(d_model)

    def forward(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None):
        b, t = data.shape[0], data.shape[1]
        h = data.reshape((b * t,) + tuple(data.shape[2:])).permute(0, 3, 1, 2)
        for i in range(4):
            h = F.silu(getattr(self, f"Conv_{i}")(h))
        frames = _flatten_nhwc(h).reshape(b, t, -1)
        return self.head(_encode_sequence(self.Dense_0, self.TransformerEncoder_0,
                                          self.d_model, frames, mask))


class Enc_FNN(VaeEncoder):
    """Generic MLP encoder for flattened data."""

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 hidden_dim: int = 128):
        super().__init__(latent_dim, data_dim, latent_private)
        self.Dense_0 = Linear(math.prod(self.data_dim), hidden_dim)
        self._add_head(hidden_dim)

    def forward(self, data: torch.Tensor, mask=None):
        return self.head(F.relu(self.Dense_0(data.reshape(data.shape[0], -1))))


class Enc_VideoGPT(VaeEncoder):
    """VideoGPT-style 3D conv + attention encoder for (B, T, H, W, C) video:
    strided same-pad convs, attention-residual blocks (axial attention, or
    strided block-sparse attention over the flattened spacetime tokens with
    ``attn_type="sparse"``), norm, mean pool over the volume."""

    attn_type = "axial"

    def __init__(self, latent_dim, data_dim, latent_private=None,
                 n_res_layers: int = 4, downsample: Sequence[int] = (1, 4, 4),
                 hidden: int = 64):
        super().__init__(latent_dim, data_dim, latent_private)
        self.n_res_layers = n_res_layers
        channels = int(self.data_dim[-1])
        self.n_down = 0
        for strides in resample_strides(downsample):
            self.add_module(f"SamePadConv3d_{self.n_down}",
                            SamePadConv3d(channels, hidden, kernel=4, strides=strides))
            channels = hidden
            self.n_down += 1
        block_cls = (SparseAttentionResidualBlock if self.attn_type == "sparse"
                     else AttentionResidualBlock)
        self.block_name = block_cls.__name__
        for i in range(n_res_layers):
            self.add_module(f"{self.block_name}_{i}", block_cls(hidden))
        self.GroupNorm_0 = GroupNorm(hidden)
        self._add_head(hidden)

    def forward(self, data: torch.Tensor, mask=None):
        h = data
        for i in range(self.n_down):
            h = getattr(self, f"SamePadConv3d_{i}")(h)
            if i < self.n_down - 1:
                h = F.relu(h)
        for i in range(self.n_res_layers):
            h = getattr(self, f"{self.block_name}_{i}")(h)
        h = F.relu(self.GroupNorm_0(h))
        return self.head(h.mean(dim=(1, 2, 3)))


class Enc_VideoGPTSparse(Enc_VideoGPT):
    """Enc_VideoGPT with strided block-sparse attention over the flattened
    spacetime tokens."""

    attn_type = "sparse"


ENCODERS = {
    "CNN": Enc_CNN,
    "VIT": Enc_VIT,
    "CNN2": Enc_CNN2,
    "CNNCoord": Enc_CNNCoord,
    "CNNSpatial": Enc_CNNSpatial,
    "FNN": Enc_FNN,
    "MNIST": Enc_MNIST,
    "MNISTMoE": Enc_MNISTMoE,
    "RESCNN": Enc_RESCNN,
    "PolyMNIST": Enc_PolyMNIST,
    "SVHN": Enc_SVHN,
    "SVHN2": Enc_SVHN2,
    "Transformer": Enc_Transformer,
    "TxtTransformer": Enc_TxtTransformer,
    "ConvTxt": Enc_ConvTxt,
    "TxtRNN": Enc_TxtRNN,
    "TransformerIMG": Enc_TransformerIMG,
    "VideoGPT": Enc_VideoGPT,
    "VideoGPTSparse": Enc_VideoGPTSparse,
}


def get_encoder(name: str):
    """Encoder factory by config name (every encoder of the reference)."""
    if name not in ENCODERS:
        raise KeyError(f"Did not find encoder {name}; available: {sorted(ENCODERS)}")
    return ENCODERS[name]
