"""Parameter surgery: grow the latent space of a trained model
(counterpart of ``training/surgery.py``).

    new_model, new_state = grow_latents(model, new_n_latents, seed=0)

Every tensor whose size is tied to the latent width is padded with
``1e-3 * N(0, 1)`` draws (from a ``torch.Generator`` seeded ``seed``;
:func:`grow_state`) and a new model of the same class and constructor
fields (``remat`` among them) with the larger ``n_latents`` is built on the
same device and loaded with them.  The learned function of the old
latents is kept: the new latents start with near-zero influence.

Which tensors grow, as the reference picks them (its flax names are the
port's module names):

* the encoder heads' ``mu_layer`` and ``logvar_layer`` weights and biases,
  along their output axis (axis 0 of a ``Linear.weight``);
* ``pz_logvar``, ``pz_mog_loc`` and ``pz_mog_rawscale``, along their last
  axis;
* in each decoder, the one Dense the reference takes as z's consumer: of
  the Dense kernels under ``dec_<modality>`` whose input width is the
  modality's latent width, the one whose flax path sorts first (so
  ``Dense_10`` before ``Dense_2``), along its input axis (axis 1 of a
  ``Linear.weight``).  A flax DenseGeneral kernel (the attention's q/k/v
  projections, 3-D in flax) is not a candidate.

A decoder whose first z-consuming layer is not a Dense (``Dec_SVHN2``'s
transposed conv on z as a 1x1 map, the Transformer decoders' attention
when the latent width is a multiple of their heads) keeps its old width
there, in the reference too, so its grown state does not fit the grown
model: :func:`grow_latents` raises for it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from multimodal_vae_comparison_tpu_torch.models.base import MMVAE
from multimodal_vae_comparison_tpu_torch.models.nets import MultiHeadAttention

PAD_SCALE = 1e-3
_PRIOR_LEAVES = ("pz_logvar", "pz_mog_loc", "pz_mog_rawscale")


def _pad(t: torch.Tensor, axis: int, new_size: int, generator: torch.Generator) -> torch.Tensor:
    shape = list(t.shape)
    shape[axis] = new_size - t.shape[axis]
    pad = PAD_SCALE * torch.randn(shape, generator=generator, dtype=t.dtype)
    return torch.cat([t, pad.to(t.device)], dim=axis)


def _head_dim(model: MMVAE, name: str) -> int:
    """Latent head width of the modality owning parameter ``name``."""
    for spec in model.specs:
        if f"enc_{spec.name}" in name:
            return model.n_latents + (spec.private_latents or 0)
    return model.n_latents


def decoder_input_weights(model: MMVAE) -> Dict[str, str]:
    """{modality: name of the ``Linear.weight`` the reference widens} for
    each decoder that has one: its 2-D flax Dense kernels whose input width
    is the modality's latent width (shared, or shared + private), the
    first by flax path ("/"-joined, as the reference sorts them)."""
    chosen: Dict[str, Tuple[str, str]] = {}
    for mod_name, module in model.named_modules():
        if not isinstance(module, nn.Linear):
            continue
        parent_name, _, leaf = mod_name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        if isinstance(parent, MultiHeadAttention) and leaf in ("query", "key", "value"):
            continue   # DenseGeneral: (in, H, Dh) in flax
        flax_path = mod_name.replace(".", "/") + "/kernel"
        for spec in model.specs:
            total = model.n_latents + (spec.private_latents or 0)
            if (f"dec_{spec.name}" in flax_path
                    and module.in_features in (model.n_latents, total)):
                if spec.name not in chosen or flax_path < chosen[spec.name][0]:
                    chosen[spec.name] = (flax_path, f"{mod_name}.weight")
    return {k: v[1] for k, v in chosen.items()}


def grow_state(model: MMVAE, new_n_latents: int, seed: int = 0
               ) -> Dict[str, torch.Tensor]:
    """``model``'s state dict with the latent-tied tensors padded to
    ``new_n_latents`` >= its latent width (see the module docstring)."""
    if new_n_latents < model.n_latents:
        raise ValueError(f"new latent size {new_n_latents} must be the same as or "
                         f"larger than the current one, {model.n_latents}")
    state = model.state_dict()
    delta = new_n_latents - model.n_latents
    if not delta:
        return dict(state)
    generator = torch.Generator().manual_seed(seed)
    inputs = set(decoder_input_weights(model).values())
    grown = {}
    for name, t in state.items():
        head = _head_dim(model, name)
        if (("mu_layer" in name or "logvar_layer" in name)
                and name.rpartition(".")[2] in ("weight", "bias") and t.shape[0] == head):
            t = _pad(t, 0, head + delta, generator)
        elif name in _PRIOR_LEAVES and t.shape[-1] == model.n_latents:
            t = _pad(t, t.dim() - 1, new_n_latents, generator)
        elif name in inputs:
            t = _pad(t, 1, t.shape[1] + delta, generator)
        grown[name] = t
    return grown


def grow_latents(model: MMVAE, new_n_latents: int, seed: int = 0
                 ) -> Tuple[MMVAE, Dict[str, torch.Tensor]]:
    """(new model, its state dict): a model of ``model``'s class and fields
    at ``new_n_latents``, on its device, holding :func:`grow_state`.
    Raises ``ValueError`` where the grown state does not fit the grown
    model."""
    state = grow_state(model, new_n_latents, seed)
    new_model = type(model)(model.specs, new_n_latents, K=model.K, device=model.device,
                            obj=model.obj, beta=model.beta,
                            prior_components=model.prior_components, remat=model.remat,
                            aux_endpoint=model.aux_endpoint, dtype=model.dtype)
    shapes = {k: tuple(v.shape) for k, v in new_model.state_dict().items()}
    misfit = sorted(k for k, v in state.items() if tuple(v.shape) != shapes[k])
    if misfit:
        raise ValueError(f"the grown state does not fit a model of {new_n_latents} "
                         f"latents at {misfit}: the surgery grows only Dense inputs")
    new_model.load_state_dict(state)
    return new_model, new_model.state_dict()
