"""Attribute classifiers ("judges") of the automatic benchmarks
(counterpart of ``eval/classifiers.py``).

A conv image classifier per attribute (shape, size, color, position,
background for CdSprites+; digits for MNIST-SVHN and PolyMNIST) and the
three video judges of SPRITES, trained on the dataset's own labeled train
split at first use and cached, in place of the reference's downloaded
``.pth`` files.  The models take channels-last input in [0, 1] (NHWC
images, (B, T, H, W, C) clips), as the JAX package's flax modules do; their
submodules carry flax's names (``Conv_0`` .., ``Dense_0``, ``Dense_1``), so
that ``bridge.load_flax_params`` loads a JAX-trained judge.  A layer whose
flax padding is ``"SAME"`` pads explicitly, as flax does: at stride 2 the
odd element of padding goes after.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_vae_comparison_tpu_torch.models.nets import _same_pads

# where the evals cache the judges they train (gitignored); the CdSprites+
# eval takes $CDSPRITES_CLASSIFIER_DIR in its place
CLASSIFIER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "classifiers")


# flax's default kernel init, lecun_normal: a normal of variance 1 / fan_in
# cut at two standard deviations, its scale corrected for the cut
_TRUNCATED_STD = 0.87962566103423978


def _flax_init(module: nn.Module) -> None:
    """Every conv and dense layer of ``module`` drawn as flax draws it:
    kernels from lecun_normal, biases zero.  The judges' recipes (epochs,
    learning rate) are the JAX package's, tuned for this scale: from
    PyTorch's default (a uniform of a third of the variance) the frame
    attribute judge trains far slower and ends its 40 epochs well below the
    JAX package's on the same rows."""
    for layer in module.modules():
        if isinstance(layer, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            fan_in = layer.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / _TRUNCATED_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std)
            nn.init.zeros_(layer.bias)


@contextlib.contextmanager
def _seeded(module: nn.Module, seed: int):
    """Build the layers of ``module`` in the block, then draw their weights
    as flax does (:func:`_flax_init`) from ``seed`` on the CPU, leaving the
    global generator as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield
        _flax_init(module)


def _same_conv3d(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on an NCDHW tensor with flax's ``"SAME"`` padding."""
    pads = [_same_pads(n, conv.kernel_size[i], conv.stride[i])
            for i, n in enumerate(x.shape[2:])]
    return conv(F.pad(x, pads[2] + pads[1] + pads[0]))


def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def _heads_out(out: torch.Tensor, heads: int, num_classes: int) -> torch.Tensor:
    return out.view(out.shape[0], heads, num_classes) if heads else out


class CNNClassifier(nn.Module):
    """Four Conv(4, stride 2, padding 1) + ReLU, a flatten in (h, w, c)
    order (flax flattens NHWC), Dense(hidden_dim) + ReLU and a Dense head.

    ``heads > 0`` returns (B, heads, num_classes) logits, a multi-attribute
    judge.  Weights are drawn on the CPU from ``seed``; move the module to
    its device after."""

    def __init__(self, num_classes: int, hid_channels: int = 32, hidden_dim: int = 256,
                 heads: int = 0, in_shape: Tuple[int, int, int] = (64, 64, 3), seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        self.heads = heads
        h, w, c = in_shape
        with _seeded(self, seed):
            for i in range(4):
                self.add_module(f"Conv_{i}", nn.Conv2d(c if i == 0 else hid_channels,
                                                       hid_channels, 4, stride=2, padding=1))
                h, w = (h - 2) // 2 + 1, (w - 2) // 2 + 1
            self.Dense_0 = nn.Linear(h * w * hid_channels, hidden_dim)
            self.Dense_1 = nn.Linear(hidden_dim, max(heads, 1) * num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        for i in range(4):
            h = torch.relu(getattr(self, f"Conv_{i}")(h))
        h = h.permute(0, 2, 3, 1).flatten(1)
        return _heads_out(self.Dense_1(torch.relu(self.Dense_0(h))), self.heads,
                          self.num_classes)


class VideoClassifier(nn.Module):
    """3-D conv video judge: three Conv3d(3, strides (1, 2, 2), SAME) + ReLU
    of ``hidden``, 2 ``hidden`` and 2 ``hidden`` channels, a mean pool over
    (T, H, W), Dense(4 ``hidden``) + ReLU and a Dense head; ``heads > 0``
    returns (B, heads, num_classes) logits.  Takes (B, T, H, W, C) clips."""

    def __init__(self, num_classes: int, hidden: int = 32, heads: int = 0,
                 in_channels: int = 3, seed: int = 0):
        super().__init__()
        self.num_classes, self.heads = num_classes, heads
        with _seeded(self, seed):
            c = in_channels
            for i, feats in enumerate((hidden, hidden * 2, hidden * 2)):
                self.add_module(f"Conv_{i}", nn.Conv3d(c, feats, 3, stride=(1, 2, 2)))
                c = feats
            self.Dense_0 = nn.Linear(c, hidden * 4)
            self.Dense_1 = nn.Linear(hidden * 4, max(heads, 1) * num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 4, 1, 2, 3)
        for i in range(3):
            h = torch.relu(_same_conv3d(getattr(self, f"Conv_{i}"), h))
        out = self.Dense_1(torch.relu(self.Dense_0(h.mean(dim=(2, 3, 4)))))
        return _heads_out(out, self.heads, self.num_classes)


class FrameAttributeClassifier(CNNClassifier):
    """Multi-head attribute judge on frame 0 of a clip (the attributes are
    static): the CNN judge with a spatial flatten (no pool, so where each
    colour lies is kept) and ``heads`` x ``num_classes`` logits, (B, heads,
    num_classes).  Takes (B, T, H, W, C) clips or (B, H, W, C) frames;
    ``in_shape`` is a frame's (H, W, C)."""

    def __init__(self, num_classes: int, heads: int = 4, hid_channels: int = 32,
                 hidden_dim: int = 256, in_shape: Sequence[int] = (64, 64, 3),
                 seed: int = 0):
        super().__init__(num_classes, hid_channels, hidden_dim, heads,
                         tuple(in_shape[-3:]), seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x[:, 0] if x.dim() == 5 else x)


class ActionVideoClassifier(nn.Module):
    """Motion-aware action judge: the frame-to-frame differences (zero at
    t = 0) concatenated onto the channels, three Conv3d(3, SAME) + ReLU of
    ``hid_channels``, 2x and 2x channels at strides (1, 2, 2), (2, 2, 2),
    (2, 2, 2), a spatiotemporal flatten in (t, h, w, c) order,
    Dense(hidden_dim) + ReLU and ``num_classes`` logits.  Takes (B, T, H,
    W, C) clips of ``in_shape``."""

    def __init__(self, num_classes: int, hid_channels: int = 32, hidden_dim: int = 256,
                 in_shape: Sequence[int] = (8, 64, 64, 3), seed: int = 0):
        super().__init__()
        t, h, w, c = in_shape
        c *= 2
        with _seeded(self, seed):
            for i, feats in enumerate((hid_channels, hid_channels * 2, hid_channels * 2)):
                strides = (1 if i == 0 else 2, 2, 2)
                self.add_module(f"Conv_{i}", nn.Conv3d(c, feats, 3, stride=strides))
                t, h, w = (_same_out(n, s) for n, s in zip((t, h, w), strides))
                c = feats
            self.Dense_0 = nn.Linear(t * h * w * c, hidden_dim)
            self.Dense_1 = nn.Linear(hidden_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        delta = torch.cat([torch.zeros_like(x[:, :1]), x[:, 1:] - x[:, :-1]], dim=1)
        h = torch.cat([x, delta], dim=-1).permute(0, 4, 1, 2, 3)
        for i in range(3):
            h = torch.relu(_same_conv3d(getattr(self, f"Conv_{i}"), h))
        h = h.permute(0, 2, 3, 4, 1).flatten(1)
        return self.Dense_1(torch.relu(self.Dense_0(h)))


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def train_classifier(model: nn.Module, images: np.ndarray, labels: np.ndarray,
                     epochs: int = 12, batch_size: int = 128, lr: float = 1e-3,
                     seed: int = 0, log_fn=None) -> nn.Module:
    """Train ``model`` in place on (images, int labels) and return it.

    As the JAX package trains: the data is staged on the model's device
    once, in one order drawn with ``np.random.default_rng(seed)``, and every
    epoch runs the same ``n // batch_size`` batches (one short batch when
    ``n < batch_size``) with plain Adam (optax.adam's defaults, eps 1e-8)
    on the mean softmax cross-entropy.  The config name "adam" of the
    training optimizers is amsgrad, which is not what the judges use.
    """
    device = _device_of(model)
    labels = np.asarray(labels)
    n = len(images)
    n_batches = max(n // batch_size, 1)
    usable = n_batches * min(batch_size, n)
    order = np.random.default_rng(seed).permutation(n)[:usable]
    xs = torch.from_numpy(np.ascontiguousarray(images[order], np.float32)).to(device)
    xs = xs.view(n_batches, -1, *images.shape[1:])
    # labels may carry extra per-head dims, e.g. (N, 4) attribute targets
    ys = torch.from_numpy(labels[order].astype(np.int64)).to(device)
    ys = ys.view(n_batches, -1, *labels.shape[1:])
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    model.train()
    for epoch in range(epochs):
        total = torch.zeros((), device=device)
        for x, y in zip(xs, ys):
            logits = model(x)
            loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            total += loss.detach()
        if log_fn:
            log_fn(f"classifier epoch {epoch}: loss={total.item() / n_batches:.4f}")
    model.eval()
    return model


@torch.inference_mode()
def _argmax_batches(model: nn.Module, images, batch_size: int):
    model.eval()
    device = _device_of(model)
    for b in range(0, len(images), batch_size):
        chunk = np.ascontiguousarray(images[b:b + batch_size], np.float32)
        yield model(torch.from_numpy(chunk).to(device)).argmax(-1).cpu().numpy()


def predict(model: nn.Module, images, batch_size: int = 256) -> np.ndarray:
    """Arg-max class of each image or clip (channels-last float in [0, 1]):
    (N,) or, for a multi-head judge, (N, heads)."""
    return np.concatenate(list(_argmax_batches(model, images, batch_size)))


def classifier_accuracy(model: nn.Module, images, labels, batch_size: int = 256) -> float:
    """Share of labels predicted; a multi-head judge's (B, heads) labels
    count ``heads`` matches an image."""
    labels = np.asarray(labels)
    return float((predict(model, images, batch_size) == labels).sum()) / max(labels.size, 1)


def judge_calibration(model: nn.Module, images, labels, name: str = "judge",
                      batch_size: int = 256) -> float:
    """The judge's accuracy on held-out real labeled data, as a fraction,
    printed beside the judged metrics: a judged coherence number means
    something only next to what the judge scores on real data."""
    acc = classifier_accuracy(model, images, labels, batch_size=batch_size)
    print(f"[judge] {name}_accuracy_real: {100 * acc:.1f}%")
    return acc


def save_classifier(model: nn.Module, path: str) -> None:
    """``torch.save`` of the state dict, written to a temporary file and
    renamed, so that an interrupted run leaves no truncated cache."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, tmp)
    os.replace(tmp, path)


def load_classifier(model: nn.Module, path: str) -> nn.Module:
    state = torch.load(path, map_location=_device_of(model), weights_only=True)
    model.load_state_dict(state)
    return model.eval()


def mods_by_type(exp) -> Dict[str, str]:
    """{mod_type -> modality name} from the run config (later modality wins
    on duplicate mod_types)."""
    return {m.mod_type: m.name for m in exp.config.mods}


def digit_classifiers(exp, cache_dir: str, prefix: str, num_classes: int = 10,
                      epochs: int = 6) -> Dict[str, nn.Module]:
    """One digit judge per modality (MNIST-SVHN and PolyMNIST), trained on
    the DataModule's train split with its aligned labels, so that
    calibration on the val split is held out."""
    out = {}
    for i, name in enumerate(exp.mod_names):
        model = CNNClassifier(num_classes, in_shape=tuple(exp.config.mods[i].feature_dims))
        cache = os.path.join(cache_dir, f"{prefix}_digit_{name}_v2.pt")

        def data_fn(i=i):
            data, _ = exp.datamod.split_arrays(i, "train")
            return data.astype(np.float32), np.asarray(exp.datamod.labels_train)

        out[name] = get_or_train_classifier(cache, model.to(exp.device), data_fn,
                                            epochs=epochs)
    return out


def get_or_train_classifier(cache_path: str, model: nn.Module,
                            data_fn: Callable[[], Tuple[np.ndarray, np.ndarray]],
                            **train_kwargs) -> nn.Module:
    """``model`` with the cached weights, or trained on ``data_fn()`` and
    cached.  A corrupt or truncated cache is deleted and trained again."""
    if os.path.exists(cache_path):
        try:
            return load_classifier(model, cache_path)
        except Exception as e:  # any unreadable file: train again
            print(f"[judge] discarding unreadable cache {cache_path}: "
                  f"{type(e).__name__}: {e}")
            os.remove(cache_path)
    images, labels = data_fn()
    train_classifier(model, images, labels, **train_kwargs)
    save_classifier(model, cache_path)
    return model
