"""Parameters sharded over a ``model`` mesh axis (counterpart of
``parallel/tensor_sharding.py``).

The reference's two rules, applied to the flax layout of each parameter:

* :func:`infer_param_sharding`: shard the last dim of every big kernel of
  two or more dims;
* :func:`megatron_param_sharding`: conv kernels (three or more dims) shard
  their last (output-channel) dim; within each module scope the k-th big
  2-D kernel is column-parallel (last dim) for even k and row-parallel
  (first dim) for odd k, counted in the reference's order: the flax tree's
  paths sorted (``Dense_10`` before ``Dense_2``), not PyTorch's
  registration order.

The port's parameters carry flax's module names (``bridge.py``), so each
one's flax path and shape follow from its module: a Dense kernel ``(in,
out)`` is torch ``(out, in)``, a DenseGeneral q/k/v kernel ``(in, H, Dh)``
is ``(H*Dh, in)``, a conv kernel ``HWIO`` is ``OIHW`` and a transposed
conv's ``(*spatial, in, out)`` is ``(in, out, *spatial)``; the flax dim a
rule shards names the torch dim that :func:`apply_param_sharding` shards
(a DenseGeneral's merged ``H*Dh`` dim takes its ``Dh`` shard: the rank
holds as many elements as the JAX device, not the same ones).

As in the reference, where the annotations are placement hints for XLA,
the shards are where parameters and optimizer state are stored: each
layer gathers its weight where it uses it (a parametrization that
all-gathers the DTensor's shards and hands the layer the whole tensor),
and the gradient comes back to the parameter's placement as this rank's
chunk.  The
kernels see plain local tensors.  The data-axis reduction of the gradient
is the train step's (``training/trainer.py``), on the local shards.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor
from torch.nn.utils import parametrize

from multimodal_vae_comparison_tpu_torch.models.nets import (
    MultiHeadAttention, StridedSparseSelfAttention)

_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
_CONV_TRANSPOSES = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)
_NORMS = (nn.LayerNorm, nn.GroupNorm)
# the q/k/v projections that flax keeps as DenseGeneral to (H, Dh)
_HEADED = (MultiHeadAttention, StridedSparseSelfAttention)


def _flax_leaf(model: nn.Module, name: str) -> Optional[Tuple[Tuple[str, ...], tuple, list]]:
    """(flax path, flax shape, torch dim of each flax dim) of the parameter
    ``name``, or None where flax has no one leaf for it (a GRU's stacked
    gates)."""
    *mod_path, leaf = name.split(".")
    module = model.get_submodule(".".join(mod_path))
    shape = tuple(model.get_parameter(name).shape)
    if isinstance(module, nn.GRU):
        return None
    if isinstance(module, nn.Linear):
        parent = model.get_submodule(".".join(mod_path[:-1])) if mod_path else None
        heads = (parent.num_heads if isinstance(parent, _HEADED)
                 and mod_path[-1] in ("query", "key", "value") else None)
        if leaf == "weight":
            out, inp = shape
            if heads:
                return (*mod_path, "kernel"), (inp, heads, out // heads), [1, 0, 0]
            return (*mod_path, "kernel"), (inp, out), [1, 0]
        if heads:
            return (*mod_path, "bias"), (heads, shape[0] // heads), [0, 0]
        return (*mod_path, "bias"), shape, [0]
    spatial = len(shape) - 2
    if isinstance(module, _CONV_TRANSPOSES) and leaf == "weight":   # (I, O, *sp)
        return ((*mod_path, "kernel"), shape[2:] + shape[:2],
                [2 + k for k in range(spatial)] + [0, 1])
    if isinstance(module, _CONVS) and leaf == "weight":             # (O, I, *sp)
        return ((*mod_path, "kernel"), shape[2:] + (shape[1], shape[0]),
                [2 + k for k in range(spatial)] + [1, 0])
    if isinstance(module, _NORMS) and leaf == "weight":
        return (*mod_path, "scale"), shape, [0]
    return (*mod_path, leaf), shape, list(range(len(shape)))


def flax_layout(model: nn.Module) -> Dict[str, Tuple[Tuple[str, ...], tuple, list]]:
    """{torch parameter name: (flax path, flax shape, torch dim of each flax
    dim)} for every parameter with one flax leaf."""
    out = {}
    for name, _ in model.named_parameters():
        leaf = _flax_leaf(model, name)
        if leaf is not None:
            out[name] = leaf
    return out


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _placements(mesh: DeviceMesh, axis: str, torch_dim: Optional[int]) -> List[Placement]:
    return [Shard(torch_dim) if name == axis and torch_dim is not None else Replicate()
            for name in mesh.mesh_dim_names]


def _size(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def infer_param_sharding(model: nn.Module, mesh: DeviceMesh, axis: str = "model",
                         min_size: int = 2048) -> Dict[str, List[Placement]]:
    """{parameter name: placements}: the last flax dim of every kernel of two
    or more dims and ``min_size`` or more elements sharded over ``axis``
    where it divides, everything else replicated."""
    size = _axis_size(mesh, axis)
    layout = flax_layout(model)
    specs = {}
    for name, _ in model.named_parameters():
        dim = None
        if name in layout:
            _, shape, dims = layout[name]
            if len(shape) >= 2 and _size(shape) >= min_size and shape[-1] % size == 0:
                dim = dims[-1]
        specs[name] = _placements(mesh, axis, dim)
    return specs


def megatron_param_sharding(model: nn.Module, mesh: DeviceMesh, axis: str = "model",
                            min_size: int = 2048) -> Dict[str, List[Placement]]:
    """The reference's column/row alternation (module docstring), as
    {parameter name: placements}."""
    size = _axis_size(mesh, axis)
    layout = flax_layout(model)
    order = defaultdict(int)     # big 2-D kernels seen so far in each scope
    flax_dim = {}
    for name in sorted(layout, key=lambda n: layout[n][0]):
        path, shape, _ = layout[name]
        nd = len(shape)
        if nd < 2 or _size(shape) < min_size:
            continue
        if nd >= 3:
            flax_dim[name] = nd - 1 if shape[-1] % size == 0 else None
            continue
        scope = path[:-2] if len(path) >= 2 else path[:-1]
        k = order[scope]
        order[scope] += 1
        if k % 2 == 0 and shape[-1] % size == 0:
            flax_dim[name] = 1
        elif k % 2 == 1 and shape[-2] % size == 0:
            flax_dim[name] = 0
        elif shape[-1] % size == 0:
            flax_dim[name] = 1
    specs = {}
    for name, _ in model.named_parameters():
        d = flax_dim.get(name)
        specs[name] = _placements(mesh, axis, None if d is None else layout[name][2][d])
    return specs


def _gather(local: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """The whole tensor of the shards ``local`` of ``placements`` on ``mesh``:
    one c10d all-gather over each mesh dim that shards it.  (DTensor's
    ``redistribute`` takes the functional collectives, which crash on gloo
    with CUDA tensors: gloo ranks on one card.)"""
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            group = mesh.get_group(mesh_dim)
            n = dist.get_world_size(group)
            parts = torch.empty((n * local.shape[0],) + tuple(local.shape[1:]),
                                dtype=local.dtype, device=local.device)
            dist.all_gather_into_tensor(parts, local.contiguous(), group=group)
            local = torch.cat(parts.chunk(n), dim=p.dim)
    return local


class _GatherShards(torch.autograd.Function):
    """Forward: the whole tensor of the shards; backward: this rank's chunk of
    the whole tensor's gradient (Replicate to Shard, no collective)."""

    @staticmethod
    def forward(ctx, local, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return _gather(local, mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        for mesh_dim, p in reversed(list(enumerate(ctx.placements))):
            if isinstance(p, Shard):
                n, i = ctx.mesh.size(mesh_dim), ctx.mesh.get_local_rank(mesh_dim)
                grad = grad.chunk(n, dim=p.dim)[i]
        return grad.contiguous(), None, None


class _Gathered(nn.Module):
    """The whole weight of a sharded parameter, as a plain local tensor; its
    gradient comes back to the parameter's placement."""

    def forward(self, x: DTensor) -> torch.Tensor:
        return _GatherShards.apply(x.to_local(), x.device_mesh, x.placements)


def apply_param_sharding(model: nn.Module, shardings: Dict[str, List[Placement]],
                         mesh: DeviceMesh) -> nn.Module:
    """Store each parameter of ``model`` as a DTensor of its placements on
    ``mesh`` (from this rank's full copy, so call :func:`mesh.shard_params`
    first), gathered where its layer reads it.  Parameters every placement
    replicates stay plain tensors.  Build the optimizer after this."""
    for name, placements in shardings.items():
        if all(isinstance(p, Replicate) for p in placements):
            continue
        *mod_path, leaf = name.split(".")
        module = model.get_submodule(".".join(mod_path))
        param = getattr(module, leaf)
        sharded = distribute_tensor(param.detach(), mesh, placements)
        setattr(module, leaf, nn.Parameter(sharded, requires_grad=param.requires_grad))
        parametrize.register_parametrization(module, leaf, _Gathered(), unsafe=True)
    return model


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole tensor (every rank of its mesh takes part), else
    ``t``."""
    if not isinstance(t, DTensor):
        return t
    with torch.no_grad():
        return _gather(t.to_local(), t.device_mesh, t.placements)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state under one device's names and shapes (every rank
    takes part: the sharded tensors are gathered)."""
    return {name.replace("parametrizations.", "").replace(".original", ""): whole(t)
            for name, t in model.state_dict().items()}
