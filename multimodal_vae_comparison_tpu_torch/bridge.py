"""Load a flax parameter tree of the reference into the port's modules.

The inverse of the converters in the reference's ``eval/weights.py``.  The
port's modules carry flax's names, so a flax leaf ``a/b/c/kernel`` lands on
the module ``a.b.c``; how it is laid out there depends on that module (the
models, and the judges of ``eval/classifiers.py``, the video ones among
them, are built of these layers):

* ``nn.Linear``: Dense ``(in, out)`` -> ``(out, in)``; DenseGeneral
  ``(in, H, Dh)`` -> ``(H*Dh, in)`` and its bias ``(H, Dh)`` -> ``(H*Dh,)``;
* ``nn.Conv2d``, ``nn.Conv3d``: HWIO -> OIHW, DHWIO -> OIDHW (a CoordConv
  kernel's input channels keep the reference's order, the two coordinate
  channels last, since ``Enc_CNNCoord`` appends them after the features);
* ``nn.ConvTranspose2d``, ``nn.ConvTranspose3d``: the kernel reversed on
  every spatial axis and laid out ``(in, out, *spatial)`` (flax's transposed
  conv does not flip the kernel; PyTorch's does), whatever flax's padding:
  the module crops for it (``Dec_SVHN``'s ``VALID`` one is PyTorch's
  unpadded one, ``Dec_PolyMNIST``'s ``SAME`` ones at stride 2 cut a row
  and a column);
* ``nn.LayerNorm``, ``nn.GroupNorm``: ``scale`` -> ``weight``;
* ``FrozenBatchNorm``: ``scale`` -> ``weight``, ``bias`` -> ``bias``, and
  the stop-gradient statistics ``mean`` and ``var`` -> its two buffers;
* a leaf of any other module (``pz_logvar``, ``Enc_CNNSpatial``'s
  ``ss_log_temp``) is copied as it is.

Every flax leaf is consumed exactly once and every parameter and buffer of
the module is written exactly once; a missing, extra or misshapen name
raises.
The tree holds numpy arrays (``jax.tree_util.tree_map(np.asarray, p)``),
so this module needs no JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_vae_comparison_tpu_torch.models.nets import FrozenBatchNorm

def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


_CONVS = (nn.Conv2d, nn.Conv3d)
_CONV_TRANSPOSES = (nn.ConvTranspose2d, nn.ConvTranspose3d)
_NORMS = (nn.LayerNorm, nn.GroupNorm)
_LAYERS = (nn.Linear, FrozenBatchNorm) + _CONVS + _CONV_TRANSPOSES + _NORMS


def _convert(module: nn.Module, leaf: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """(torch parameter name, array in the torch layout) for one flax leaf."""
    if isinstance(module, nn.Linear):
        if leaf == "kernel":  # Dense (in, out) or DenseGeneral (in, H, Dh)
            return "weight", arr.reshape(arr.shape[0], -1).T
        if leaf == "bias":
            return "bias", arr.reshape(-1)
    elif isinstance(module, _CONV_TRANSPOSES):
        if leaf == "kernel":   # (*spatial, in, out), not flipped
            spatial = tuple(range(arr.ndim - 2))
            return "weight", np.flip(arr, spatial).transpose(-2, -1, *spatial)
        if leaf == "bias":
            return "bias", arr
    elif isinstance(module, _CONVS):
        if leaf == "kernel":   # (*spatial, in, out)
            return "weight", arr.transpose(-1, -2, *range(arr.ndim - 2))
        if leaf == "bias":
            return "bias", arr
    elif isinstance(module, _NORMS):
        if leaf == "scale":
            return "weight", arr
        if leaf == "bias":
            return "bias", arr
    elif isinstance(module, FrozenBatchNorm):
        if leaf in ("mean", "var", "bias"):
            return leaf, arr
        if leaf == "scale":
            return "weight", arr
    raise KeyError(f"no rule for flax leaf '{leaf}' on {type(module).__name__}")


def load_flax_params(model: nn.Module, flax_params: Mapping) -> None:
    """Copy ``flax_params`` (the variables dict or its ``"params"`` entry)
    into ``model`` in place."""
    tree = flax_params.get("params", flax_params)
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    written = set()
    with torch.no_grad():
        for path, arr in _flatten(tree).items():
            *mod_path, leaf = path
            try:
                module = model.get_submodule(".".join(mod_path))
            except AttributeError as e:
                raise KeyError(f"flax leaf {'/'.join(path)} has no module "
                               f"in {type(model).__name__}") from e
            if isinstance(module, _LAYERS):
                name, value = _convert(module, leaf, arr)
            else:  # a parameter of a container module, e.g. pz_logvar
                name, value = leaf, arr
            full = ".".join(mod_path + [name])
            if full not in targets:
                raise KeyError(f"flax leaf {'/'.join(path)} -> '{full}' is not "
                               f"a parameter or buffer of {type(model).__name__}")
            if full in written:
                raise KeyError(f"parameter '{full}' written twice")
            param = targets[full]
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"flax leaf {'/'.join(path)} has shape "
                                 f"{arr.shape} -> {value.shape}; '{full}' "
                                 f"has {tuple(param.shape)}")
            param.copy_(torch.tensor(np.ascontiguousarray(value), dtype=torch.float32))
            written.add(full)
    missing = sorted(set(targets) - written)
    if missing:
        raise KeyError(f"parameters or buffers with no flax leaf: {missing}")
