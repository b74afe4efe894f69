"""Model assembly and the train/eval steps (counterpart of ``training/trainer.py``).

    model = build_model(specs, "poe", n_latents=16, obj="elbo", device="cuda")
    opt = make_optimizer("adam", 1e-3, model.parameters())
    step = make_train_step(model, opt)
    metrics = step(batch)          # {"loss": ..., "kld": ..., ...} tensors

A batch is ``{"mod_1": {"data": tensor, "masks": tensor or None}, ...}`` on
the model's device.  PyTorch runs eagerly, so a step is a plain function:
objective, backward, one optimizer update.  Whole-epoch runners,
checkpoints, loggers and ``Trainer.fit`` come with the config/data slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from multimodal_vae_comparison_tpu_torch.models import get_mixing
from multimodal_vae_comparison_tpu_torch.models.base import MMVAE, ModalitySpec


def build_model(specs: Tuple[ModalitySpec, ...], mixing: str, n_latents: int,
                obj: str = "elbo", beta: float = 1.0, K: int = 1, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                remat: bool = False) -> MMVAE:
    """The model of a config: the mixing class named by ``mixing`` over one
    VAE per modality spec, weights drawn from ``seed``, on ``device``
    (CUDA unless the caller passes ``"cpu"``); ``remat`` recomputes the
    nets' activations in the backward pass instead of keeping them."""
    if len(specs) == 1:
        raise NotImplementedError(
            "the unimodal VAE (one modality) is not ported yet "
            "(ROADMAP Queue A item 3)")
    return get_mixing(mixing)(specs, n_latents, K=K, seed=seed, device=device,
                              obj=obj, beta=beta, remat=remat)


def _chunk(batch, eps, g: int, G: int):
    """Chunk ``g`` of ``G``, strided (rows g, g+G, ...) as the reference
    splits a batch; injected (K, B, D) draws are split the same way."""
    sub = {name: {k: None if v is None else v[g::G] for k, v in mod.items()}
           for name, mod in batch.items()}
    if eps is None:
        return sub, None
    if isinstance(eps, dict):
        return sub, {k: e[:, g::G] for k, e in eps.items()}
    return sub, [e[:, g::G] for e in eps]


def _batch_size(batch) -> int:
    return next(mod["data"].shape[0] for mod in batch.values()
                if mod.get("data") is not None)


def make_train_step(model: MMVAE, opt: torch.optim.Optimizer, grad_accum: int = 1):
    """``step(batch, eps=None, generator=None) -> metrics``: the model's
    objective, its gradient, and one optimizer update; ``metrics`` holds the
    objective's metrics and ``loss``, as detached tensors.

    With ``grad_accum = G > 1`` the batch splits into G strided chunks
    (chunk g is ``x[g::G]``); each chunk's gradient is summed, the sum is
    scaled by 1/G and one update is taken, and the loss and metrics are
    the chunks' mean.  A batch that G does not divide raises.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch, eps=None, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        model.train()
        opt.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss, metrics = model.objective(batch, eps=eps, generator=generator)
            loss.backward()
            out = {k: v.detach() for k, v in metrics.items()}
            out["loss"] = loss.detach()
        else:
            n = _batch_size(batch)
            if n % grad_accum:
                raise ValueError(f"batch {n} is not divisible by "
                                 f"grad_accum={grad_accum}")
            out = {}
            for g in range(grad_accum):
                sub, sub_eps = _chunk(batch, eps, g, grad_accum)
                loss, metrics = model.objective(sub, eps=sub_eps, generator=generator)
                loss.backward()
                metrics = dict(metrics, loss=loss)
                for k, v in metrics.items():
                    out[k] = out.get(k, 0.0) + v.detach()
            inv = 1.0 / grad_accum
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(inv)
            out = {k: v * inv for k, v in out.items()}
        opt.step()
        return out

    return step


def make_eval_step(model: MMVAE):
    """``eval_step(batch, eps=None, generator=None) -> metrics``: the
    objective's metrics and ``loss`` without a gradient."""

    def eval_step(batch, eps=None, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            loss, metrics = model.objective(batch, eps=eps, generator=generator)
        out = dict(metrics)
        out["loss"] = loss
        return out

    return eval_step
