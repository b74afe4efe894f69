"""Load a flax parameter tree of the reference into the port's modules.

The inverse of the converters in the reference's ``eval/weights.py``.  The
port's modules carry flax's names, so a flax leaf ``a/b/c/kernel`` lands on
the module ``a.b.c``; how it is laid out there depends on that module (the
models, and the judges of ``eval/classifiers.py``, the video ones among
them, are built of these layers):

* ``nn.Linear``: Dense ``(in, out)`` -> ``(out, in)``; DenseGeneral
  ``(in, H, Dh)`` -> ``(H*Dh, in)`` and its bias ``(H, Dh)`` -> ``(H*Dh,)``;
* ``nn.Conv1d``, ``nn.Conv2d``, ``nn.Conv3d``: WIO -> OIW, HWIO -> OIHW,
  DHWIO -> OIDHW (a CoordConv
  kernel's input channels keep the reference's order, the two coordinate
  channels last, since ``Enc_CNNCoord`` appends them after the features);
* ``nn.ConvTranspose1d``, ``2d``, ``3d``: the kernel reversed on every
  spatial axis and laid out ``(in, out, *spatial)`` (flax's transposed
  conv does not flip the kernel; PyTorch's does), whatever flax's padding:
  the module crops for it (``Dec_SVHN``'s ``VALID`` one is PyTorch's
  unpadded one, ``Dec_PolyMNIST``'s and ``Dec_ConvTxt``'s ``SAME`` ones at
  stride 2 cut a row and a column, or the last step);
* ``nn.GRU`` (one layer, one direction): the ten leaves of a flax
  ``GRUCell``, input Denses ``ir``, ``iz``, ``in`` with bias and hidden
  Denses ``hr``, ``hz`` without and ``hn`` with, stack in PyTorch's gate
  order r, z, n: ``weight_ih_l0`` and ``weight_hh_l0`` the three kernels,
  transposed; ``bias_ih_l0`` the three input biases; ``bias_hh_l0``
  ``[0, 0, b_hn]`` (PyTorch's n gate multiplies ``W_hn h + b_hn`` by r, as
  flax's does);
* ``nn.LayerNorm``, ``nn.GroupNorm``: ``scale`` -> ``weight``;
* ``FrozenBatchNorm``: ``scale`` -> ``weight``, ``bias`` -> ``bias``, and
  the stop-gradient statistics ``mean`` and ``var`` -> its two buffers;
* a leaf of any other module (``pz_logvar``, ``Enc_CNNSpatial``'s
  ``ss_log_temp``, the ViT's ``cls`` and ``pos_embed``) is copied as it is.

The frozen feature nets load by the same rules: ``VGGFeatures``'s
``Conv_0`` .. ``Conv_7`` are 2-D convs, and ``InceptionV3``'s
torchvision-named ``<block>.conv`` / ``<block>.bn`` a 2-D conv and a
FrozenBatchNorm each.

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


_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
_CONV_TRANSPOSES = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)
_GRU_GATES = ("r", "z", "n")
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


def _gru_prefix(model: nn.Module, mod_path) -> int:
    """The length of the prefix of ``mod_path`` that names an ``nn.GRU`` of
    ``model``, or 0."""
    for n in range(len(mod_path) - 1, 0, -1):
        try:
            module = model.get_submodule(".".join(mod_path[:n]))
        except AttributeError:
            continue
        return n if isinstance(module, nn.GRU) else 0
    return 0


def _gru_params(cell: Dict[Tuple[str, ...], np.ndarray], where: str):
    """{torch parameter name: array} of one flax ``GRUCell``'s leaves, keyed
    (dense, leaf)."""
    want = {(f"{side}{g}", "kernel") for side in "ih" for g in _GRU_GATES}
    want |= {(f"i{g}", "bias") for g in _GRU_GATES} | {("hn", "bias")}
    if set(cell) != want:
        raise KeyError(f"flax GRUCell {where} has leaves {sorted(cell)}; expected "
                       f"{sorted(want)}")
    hn = cell[("hn", "bias")]
    return {
        "weight_ih_l0": np.concatenate([cell[(f"i{g}", "kernel")].T for g in _GRU_GATES]),
        "weight_hh_l0": np.concatenate([cell[(f"h{g}", "kernel")].T for g in _GRU_GATES]),
        "bias_ih_l0": np.concatenate([cell[(f"i{g}", "bias")] for g in _GRU_GATES]),
        "bias_hh_l0": np.concatenate([np.zeros(2 * hn.shape[0], hn.dtype), hn]),
    }


def load_flax_params(model: nn.Module, flax_params: Mapping) -> None:
    """Copy ``flax_params`` (the variables dict or its ``"params"`` entry)
    into ``model`` in place."""
    tree = flax_params.get("params", flax_params)
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    written = set()
    leaves, grus = [], {}
    for path, arr in _flatten(tree).items():
        n = _gru_prefix(model, path[:-1])
        if n:   # a GRUCell's leaf: gathered, then stacked in PyTorch's layout
            grus.setdefault(path[:n], {})[path[n:]] = arr
        else:
            leaves.append((path, arr))
    for gru_path, cell in grus.items():
        where = "/".join(gru_path)
        leaves += [(gru_path + (name,), value) for name, value in _gru_params(cell, where).items()]
    with torch.no_grad():
        for path, arr in leaves:
            *mod_path, leaf = path
            try:
                module = model.get_submodule(".".join(mod_path))
            except AttributeError as e:
                raise KeyError(f"flax leaf {'/'.join(path)} has no module "
                               f"in {type(model).__name__}") from e
            if isinstance(module, _LAYERS):
                name, value = _convert(module, leaf, arr)
            else:  # a parameter of a container module (pz_logvar, ViT's cls)
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
