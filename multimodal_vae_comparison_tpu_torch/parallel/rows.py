"""This rank's rows of a data-parallel batch.

Under a data mesh every rank holds a block of the global batch and runs the
objective on it.  Three things in the objective depend on the rows that the
rank does not hold, and read the :class:`RowShard` that
:func:`shard_rows` sets around the rank's objective call:

* the noise: :func:`draw` makes each draw at the global batch's shape from
  the generator, which every rank holds in the same state, and keeps the
  rank's rows, so that every rank draws what one device would (the JAX
  package draws for the global batch and shards the draw);
* a mean over the batch rows (:func:`row_mean`): the rank's share of it,
  its rows' sum over the global row count, so that the shares sum to the
  global mean, and their gradients to its gradient;
* a sum that a non-linear function reads (:func:`global_sum`,
  ``optimal_sigma``'s squared error): all-reduced over the data axis with
  its gradient.

Without a shard each is the one-device computation, unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class RowShard:
    """The rank holds rows ``[start, start + n)`` of a batch of ``total``
    rows (a grad-accumulation chunk's rows, within its step); ``group`` is
    the data axis's process group."""

    start: int
    total: int
    group: object = None


_shard: contextvars.ContextVar = contextvars.ContextVar("row_shard", default=None)


def current() -> Optional[RowShard]:
    return _shard.get()


@contextlib.contextmanager
def shard_rows(shard: Optional[RowShard]):
    """Run the block with ``shard`` as the current row shard (None: one
    device)."""
    token = _shard.set(shard)
    try:
        yield shard
    finally:
        _shard.reset(token)


def draw(shape: Sequence[int], batch_dim: int,
         make: Callable[[Sequence[int]], torch.Tensor]) -> torch.Tensor:
    """``make(shape)``, or under a shard ``make`` at the global row count on
    ``batch_dim`` narrowed to the rank's rows."""
    shard = _shard.get()
    if shard is None:
        return make(tuple(shape))
    shape = list(shape)
    n = shape[batch_dim]
    shape[batch_dim] = shard.total
    return make(tuple(shape)).narrow(batch_dim, shard.start, n)


def row_mean(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The mean over the batch rows on ``dim``; under a shard the rank's
    share of the global mean (its rows' sum over the global count)."""
    shard = _shard.get()
    if shard is None:
        return x.mean(dim)
    return x.sum(dim) / shard.total


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the data axis, the gradient summed
    back to each; ``x`` itself without a shard."""
    shard = _shard.get()
    if shard is None:
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, group=shard.group)

