"""Pretrained-weight installation (counterpart of ``eval/weights.py``).

Three torchvision checkpoints are used where they are installed, none is
shipped or downloaded:

* ``resnet50``: the ImageNet ResNet-50 trunk of ``Enc_CNN``, loaded into
  every :class:`~models.nets.ResNet50` of a model by
  :func:`install_pretrained` (``Trainer.init_state`` calls it);
* ``vgg19``: the perceptual ``feature_loss``'s extractor and the FID's
  VGG features (``models/perceptual.py``);
* ``inception_v3``: the FID's InceptionV3 pool-3 features
  (``eval/fid.py``).

Each is a file ``<name>.pt``, ``.pth`` (read by ``torch.load`` with
``weights_only=True``) or ``.npz`` in the weights directory:
``$MVAE_TPU_WEIGHTS_DIR`` if set, else ``<repo>/weights``, the JAX
package's directory, so one directory serves both packages.

A torchvision state dict is already in PyTorch's layouts, so each converter
is a key map onto the port module's own ``state_dict`` keys, with every
value cast to float32 and nothing transposed.  It drops what the module
does not have (VGG's classifier, Inception's ``fc`` and ``AuxLogits``,
every ``num_batches_tracked``); loading raises on a key the module lacks
(``KeyError``) and on a shape that differs (``ValueError``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

StateDict = Dict[str, torch.Tensor]


def weights_dir() -> str:
    return os.environ.get("MVAE_TPU_WEIGHTS_DIR", os.path.join(_REPO_ROOT, "weights"))


def find_weights_file(name: str) -> Optional[str]:
    for ext in (".pt", ".pth", ".npz"):
        p = os.path.join(weights_dir(), name + ext)
        if os.path.isfile(p):
            return p
    return None


def load_state_dict(path: str) -> StateDict:
    """A torch-serialized or ``.npz`` state dict as CPU tensors."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.asarray(z[k])) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v).to(torch.float32)


def _bn(sd: Mapping, src: str, dst: str) -> StateDict:
    """A torchvision BatchNorm2d's four tensors as a FrozenBatchNorm's."""
    return {f"{dst}.weight": _f32(sd[f"{src}.weight"]), f"{dst}.bias": _f32(sd[f"{src}.bias"]),
            f"{dst}.mean": _f32(sd[f"{src}.running_mean"]),
            f"{dst}.var": _f32(sd[f"{src}.running_var"])}


# -- VGG19 (feature_loss's extractor, the FID's VGG features) ----------------------

def convert_vgg19(sd: Mapping, n_convs: int = 8) -> StateDict:
    """torchvision ``vgg19`` -> ``VGGFeatures``: its first ``n_convs`` convs,
    ``features.{0,2,5,7,10,12,14,16}`` in definition order, as ``Conv_0``
    .. ``Conv_7``."""
    conv_keys = sorted(int(k.split(".")[1]) for k in sd
                       if k.startswith("features.") and k.endswith(".weight")
                       and sd[k].ndim == 4)
    if len(conv_keys) < n_convs:
        raise ValueError(f"vgg19 state dict has {len(conv_keys)} convs, need {n_convs}")
    out = {}
    for i, idx in enumerate(conv_keys[:n_convs]):
        out[f"Conv_{i}.weight"] = _f32(sd[f"features.{idx}.weight"])
        out[f"Conv_{i}.bias"] = _f32(sd[f"features.{idx}.bias"])
    return out


# -- ResNet-50 (Enc_CNN's trunk) ----------------------------------------------------

def convert_resnet50(sd: Mapping, stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)) -> StateDict:
    """torchvision ``resnet50`` -> ``nets.ResNet50``: ``conv1`` / ``bn1`` ->
    ``Conv_0`` / ``FrozenBatchNorm_0``; ``layer{s+1}.{j}`` ->
    ``BottleneckBlock_{sum(stage_sizes[:s]) + j}`` with ``conv{c+1}`` /
    ``bn{c+1}`` -> ``Conv_{c}`` / ``FrozenBatchNorm_{c}`` and
    ``downsample.0`` / ``.1`` -> ``Conv_3`` / ``FrozenBatchNorm_3``; ``fc``
    -> ``Dense_0``."""
    out = {"Conv_0.weight": _f32(sd["conv1.weight"]), **_bn(sd, "bn1", "FrozenBatchNorm_0"),
           "Dense_0.weight": _f32(sd["fc.weight"]), "Dense_0.bias": _f32(sd["fc.bias"])}
    blk = 0
    for s, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            src, dst = f"layer{s + 1}.{j}", f"BottleneckBlock_{blk}"
            for c in range(3):
                out[f"{dst}.Conv_{c}.weight"] = _f32(sd[f"{src}.conv{c + 1}.weight"])
                out.update(_bn(sd, f"{src}.bn{c + 1}", f"{dst}.FrozenBatchNorm_{c}"))
            if f"{src}.downsample.0.weight" in sd:
                out[f"{dst}.Conv_3.weight"] = _f32(sd[f"{src}.downsample.0.weight"])
                out.update(_bn(sd, f"{src}.downsample.1", f"{dst}.FrozenBatchNorm_3"))
            blk += 1
    return out


# -- InceptionV3 (the FID's Inception features) ------------------------------------

_BN_NAMES = {"weight": "weight", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def convert_inception(sd: Mapping) -> StateDict:
    """torchvision ``inception_v3`` -> ``models/inception.InceptionV3``: the
    module paths are the same, each BatchNorm's running statistics become
    FrozenBatchNorm's ``mean`` / ``var``; ``fc``, ``AuxLogits`` and
    ``num_batches_tracked`` are dropped, any other entry raises."""
    out = {}
    for key, val in sd.items():
        parts = key.split(".")
        if parts[0] in ("fc", "AuxLogits") or parts[-1] == "num_batches_tracked":
            continue
        mod, leaf = parts[:-1], parts[-1]
        if mod and mod[-1] == "conv" and leaf == "weight":
            out[key] = _f32(val)
        elif mod and mod[-1] == "bn" and leaf in _BN_NAMES:
            out[".".join(mod + [_BN_NAMES[leaf]])] = _f32(val)
        else:
            raise KeyError(f"unexpected inception_v3 entry {key}")
    return out


def _converted(name: str, convert) -> Optional[StateDict]:
    path = find_weights_file(name)
    return None if path is None else convert(load_state_dict(path))


def vgg19_feature_params() -> Optional[StateDict]:
    """The converted ``vgg19`` file, or None when none is installed."""
    return _converted("vgg19", convert_vgg19)


def inception_feature_params() -> Optional[StateDict]:
    """The converted ``inception_v3`` file, or None when none is installed."""
    return _converted("inception_v3", convert_inception)


# -- installation into live modules ----------------------------------------------

def load_checked(module: nn.Module, converted: Mapping[str, torch.Tensor],
                 where: str = "") -> None:
    """Copy each entry of ``converted`` into the parameter or buffer of
    ``module`` of its name, in place, on the module's device and dtype: a
    name the module lacks raises ``KeyError``, a shape that differs
    ``ValueError`` (nothing is cut to fit); entries absent from
    ``converted`` are left as they are."""
    targets = dict(module.named_parameters())
    targets.update(module.named_buffers())
    for k, v in converted.items():
        if k not in targets:
            raise KeyError(f"converted weights have unknown entry {where}/{k}")
        if tuple(targets[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {where}/{k}: model "
                             f"{tuple(targets[k].shape)} vs checkpoint {tuple(v.shape)}")
    with torch.no_grad():
        for k, v in converted.items():
            targets[k].copy_(v)


def install_pretrained(model: nn.Module, verbose: bool = True) -> List[str]:
    """Load the ``resnet50`` file, where one is installed, into every
    ``ResNet50`` of ``model`` (in place).  Returns one report line per
    trunk; a no-op without the file.  A file that does not fit raises."""
    from multimodal_vae_comparison_tpu_torch.models.nets import ResNet50
    report: List[str] = []
    path = find_weights_file("resnet50")
    if path is not None:
        converted = convert_resnet50(load_state_dict(path))
        for name, sub in model.named_modules():
            if isinstance(sub, ResNet50):
                load_checked(sub, converted, name)
                report.append(f"installed resnet50 weights at {name} from {path}")
    if verbose:
        for line in report:
            print(f"[weights] {line}")
    return report
