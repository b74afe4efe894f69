"""Optimizer factory (counterpart of ``training/optim.py``).

The reference builds optax transformations; their update rules differ from
``torch.optim``'s in ways that change training, so each rule is written out
here as optax computes it, as one ``torch.optim.Optimizer``:

* ``"adam"`` is ``optax.amsgrad``: the running max is taken over the
  bias-corrected second moment, and the update is
  ``m_hat / (sqrt(nu_hat_max + eps_root) + eps)``.
  ``torch.optim.Adam(amsgrad=True)`` takes the max before bias correction
  and so moves differently after a large gradient;
* ``"adabelief"`` is ``optax.adabelief`` (eps 1e-16, eps_root 1e-16);
* ``"adamw"`` is ``optax.adamw``: Adam's update plus ``weight_decay * p``
  (1e-4), both scaled by the learning rate;
* ``"sgd"`` is ``optax.sgd`` without momentum.

The rule's name fixes its hyperparameters, as in the reference, which
takes optax's defaults for each.
"""
from __future__ import annotations

from typing import Iterable

import torch

# rule -> (b1, b2, eps, eps_root, weight_decay), optax's defaults; sgd keeps
# no moments
HYPERPARAMS = {
    "adabelief": (0.9, 0.999, 1e-16, 1e-16, 0.0),
    "adam": (0.9, 0.999, 1e-8, 0.0, 0.0),
    "adamw": (0.9, 0.999, 1e-8, 0.0, 1e-4),
    "sgd": None,
}
RULES = tuple(HYPERPARAMS)


class OptaxRule(torch.optim.Optimizer):
    """One of optax's update rules (``rule`` in :data:`RULES`) over a
    parameter list.  State per parameter: ``count`` and the moments the
    rule keeps (``mu``, ``nu``, and ``nu_max`` for amsgrad).

    optax updates every leaf on every step, so a parameter whose ``.grad``
    is ``None`` steps as if its gradient were zero."""

    def __init__(self, params: Iterable[torch.nn.Parameter], rule: str, lr: float):
        if rule not in HYPERPARAMS:
            raise KeyError(f"unknown optimizer '{rule}'; available: {list(RULES)}")
        self.rule = rule
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxRule.step takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                # a parameter sharded over a model axis steps on its shard
                # (parallel/tensor_sharding.py); its state is the shard's
                w = local_shard(p)
                g = local_shard(p.grad) if p.grad is not None else torch.zeros_like(w)
                w.add_(self._update(p, w, g), alpha=-group["lr"])

    def _update(self, p, w, g) -> torch.Tensor:
        """optax's update direction before the learning rate, for the
        parameter ``p`` whose tensor (or shard) is ``w``."""
        if self.rule == "sgd":
            return g
        b1, b2, eps, eps_root, weight_decay = HYPERPARAMS[self.rule]
        state = self.state[p]
        if not state:
            state["count"] = 0
            state["mu"] = torch.zeros_like(w)
            state["nu"] = torch.zeros_like(w)
            if self.rule == "adam":
                state["nu_max"] = torch.zeros_like(w)
        state["count"] += 1
        count = state["count"]
        mu = state["mu"].mul_(b1).add_(g, alpha=1 - b1)
        mu_hat = mu / (1 - b1 ** count)
        if self.rule == "adabelief":
            nu = state["nu"].mul_(b2).addcmul_(g - mu, g - mu, value=1 - b2).add_(eps_root)
            return mu_hat / (torch.sqrt(nu / (1 - b2 ** count)) + eps)
        nu = state["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
        nu_hat = nu / (1 - b2 ** count)
        if self.rule == "adam":
            nu_hat = torch.maximum(state["nu_max"], nu_hat, out=state["nu_max"])
        update = mu_hat / (torch.sqrt(nu_hat + eps_root) + eps)
        if weight_decay:
            update = update + weight_decay * w
        return update


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank, else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def make_optimizer(name: str, lr: float,
                   params: Iterable[torch.nn.Parameter]) -> OptaxRule:
    """The optimizer of the config's ``optimizer`` name, with optax's
    defaults for that name."""
    return OptaxRule(params, (name or "adam").lower(), lr)
