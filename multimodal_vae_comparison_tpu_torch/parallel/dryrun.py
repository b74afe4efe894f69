"""One sharded train step over N ranks (counterpart of
``__graft_entry__.py:135-197`` ``dryrun_multichip``), and the rank function
that drives a train step on a mesh for the tests and ``chip_smoke.py``.

    python -m multimodal_vae_comparison_tpu_torch.parallel.dryrun 4 --device cpu

``dryrun_multichip(n)`` starts n ranks (``parallel/launch.py``) and, as the
reference does, takes a hybrid ``(n/2, 2)`` ``("data", "model")`` mesh when
n is even and at least 4 (a data-only mesh otherwise), builds the flagship
at 8 latents and 12 characters, shards its big kernels over the model axis
(``megatron_param_sharding``, ``min_size`` 1024), and runs one amsgrad step
(lr 1e-3) with ``grad_accum`` 2 on a batch of 2 rows per data rank.  The
loss must be finite; rank 0 prints the reference's ``dryrun_multichip OK``
line.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_vae_comparison_tpu_torch.parallel.launch import Rank, launch

VOCAB = 27


def flagship_specs(seq_len: int = 45):
    """The flagship's two modalities (``__graft_entry__._flagship``)."""
    from multimodal_vae_comparison_tpu_torch.models.base import ModalitySpec
    return (ModalitySpec(name="mod_1", encoder="CNN2", decoder="CNN",
                         feature_dims=(64, 64, 3), mod_type="image", recon_loss="bce"),
            ModalitySpec(name="mod_2", encoder="TxtTransformer", decoder="TxtTransformer",
                         feature_dims=(seq_len, VOCAB), mod_type="text",
                         recon_loss="category_ce", has_masks=True))


def flagship_batch(n: int, seq_len: int = 45, seed: int = 0) -> Dict[str, Dict[str, Any]]:
    """A numpy batch of ``n`` rows in the flagship's form: images in [0, 1),
    one-hot captions and full key masks (``__graft_entry__._batch``)."""
    rng = np.random.default_rng(seed)
    txt = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (n, seq_len))]
    return {"mod_1": {"data": rng.random((n, 64, 64, 3), dtype=np.float32), "masks": None},
            "mod_2": {"data": txt, "masks": np.ones((n, seq_len), bool)}}


@dataclasses.dataclass
class StepJob:
    """One train step on a mesh, as :func:`train_step_on_mesh` runs it.

    :param batch: the GLOBAL numpy batch; each rank steps on its block
    :param eps: the GLOBAL numpy draws in the objective's form (batch on dim
        1), or None to draw from a generator seeded ``gen_seed`` on every rank
    :param state: one-device state dict (numpy) to start from, else weights
        from ``seed``
    :param shape, axes: the mesh (default: every rank on ``"data"``)
    :param sharding: ``"megatron"``, ``"infer"`` or None, over ``"model"``
    :param timed_steps: steps timed after the checked one, for a p50
    """

    specs: Tuple
    batch: Dict[str, Dict[str, Any]]
    mixing: str = "poe"
    n_latents: int = 8
    obj: str = "elbo"
    K: int = 1
    seed: int = 0
    state: Optional[Dict[str, np.ndarray]] = None
    eps: Any = None
    gen_seed: int = 0
    shape: Optional[Sequence[int]] = None
    axes: Sequence[str] = ("data",)
    sharding: Optional[str] = None
    min_size: int = 1024
    grad_accum: int = 1
    optimizer: str = "adam"
    lr: float = 1e-3
    flops: bool = False
    timed_steps: int = 0


def _eps_rows(eps, index: int, size: int, device):
    from multimodal_vae_comparison_tpu_torch.parallel.mesh import local_rows

    def one(e):
        return local_rows(torch.from_numpy(np.asarray(e)), index, size, dim=1).to(device)
    if eps is None:
        return None
    if isinstance(eps, dict):
        return {k: one(e) for k, e in eps.items()}
    if isinstance(eps, (list, tuple)):
        return [one(e) for e in eps]
    return one(eps)


def train_step_on_mesh(ctx: Rank, job: StepJob) -> Dict[str, Any]:
    """Run ``job`` in this rank of an initialized process group, under the
    port's numerics (``device.set_numerics``: fp32 without TF32, cuDNN's
    deterministic algorithms), as the one-process steps it is held against.

    :return: the step's global ``metrics`` (floats); the one-device
        ``grads`` and ``params`` after the step (numpy, every rank); each
        parameter's ``shard_shape`` on this rank; the kernels' ``launches``
        and dispatch ``paths`` over the step and the ``rows`` it stepped
        on; with ``job.flops`` this rank's ``ops.flops.step_flops`` of the
        step; with ``job.timed_steps`` the p50 ms of that many more steps
    """
    from multimodal_vae_comparison_tpu_torch.device import set_numerics
    from multimodal_vae_comparison_tpu_torch.ops import flops
    from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
    from multimodal_vae_comparison_tpu_torch.parallel import mesh as pmesh
    from multimodal_vae_comparison_tpu_torch.parallel import tensor_sharding as ts
    from multimodal_vae_comparison_tpu_torch.training.optim import local_shard, make_optimizer
    from multimodal_vae_comparison_tpu_torch.training.trainer import (
        build_model, make_train_step)

    set_numerics()
    mesh = pmesh.make_mesh(ctx.world_size, job.axes, job.shape, device_type=ctx.device.type)
    model = build_model(job.specs, job.mixing, job.n_latents, obj=job.obj, K=job.K,
                        seed=job.seed, device=ctx.device)
    if job.state is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in job.state.items()})
    pmesh.shard_params(model)
    if job.sharding is not None:
        rule = {"megatron": ts.megatron_param_sharding,
                "infer": ts.infer_param_sharding}[job.sharding]
        ts.apply_param_sharding(model, rule(model, mesh, "model", job.min_size), mesh)
    opt = make_optimizer(job.optimizer, job.lr, model.parameters())
    data = mesh["data"]
    index, size = pmesh.batch_sharding(mesh, "data")
    step = make_train_step(model, opt, grad_accum=job.grad_accum,
                           data_group=data.get_group())
    batch = pmesh.shard_batch(job.batch, mesh, "data")
    batch = {name: {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
                    .to(ctx.device) for k, v in mod.items()} for name, mod in batch.items()}
    eps = _eps_rows(job.eps, index, size, ctx.device)
    gen = torch.Generator(device=ctx.device).manual_seed(job.gen_seed)
    out: Dict[str, Any] = {}
    telemetry.reset()
    if job.flops:
        out["flops"] = flops.step_flops(step, batch, eps=eps, generator=gen)["flops"]
        metrics = None
    else:
        metrics = step(batch, eps=eps, generator=gen)
    out["launches"], out["paths"] = telemetry.launches(), telemetry.summary()
    out["rows"] = next(iter(batch.values()))["data"].shape[0]
    if metrics is not None:
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
    grads = {_one_device_name(name): None if p.grad is None
             else ts.whole(p.grad).detach().cpu().numpy()
             for name, p in model.named_parameters()}
    out["grads"] = grads
    out["params"] = {k: v.detach().cpu().numpy() for k, v in ts.full_state_dict(model).items()}
    out["shard_shape"] = {_one_device_name(n): tuple(local_shard(p).shape)
                          for n, p in model.named_parameters()}
    if job.timed_steps:
        out["step_ms_p50"] = step_ms_p50(step, batch, eps, gen, job.timed_steps)
    return out


def step_ms_p50(step, batch, eps, gen, steps: int) -> float:
    """The median wall ms of ``steps`` calls of ``step``, each ended by a
    device synchronise."""
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(batch, eps=eps, generator=gen)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _one_device_name(name: str) -> str:
    return name.replace("parametrizations.", "").replace(".original", "")


def run_steps(ctx: Rank, jobs: Sequence[StepJob], batch=None):
    """:func:`train_step_on_mesh` for each job in turn, in one process group,
    after :func:`mesh_facts` of ``batch`` where one is given:
    ``(facts or None, [result of each job])``."""
    facts = None if batch is None else mesh_facts(ctx, batch)
    return facts, [train_step_on_mesh(ctx, job) for job in jobs]


def mesh_facts(ctx: Rank, batch) -> Dict[str, Any]:
    """What this rank's meshes and its block of ``batch`` are (the tests
    read them): the default mesh's and a ``(1, N)`` hybrid mesh's shape and
    axes, the rank's data coordinate, the hybrid mesh's replicated
    placements, its rows of ``batch``'s ``m``, and the error of a shape that
    does not hold the ranks."""
    from multimodal_vae_comparison_tpu_torch.parallel import mesh as pmesh
    default = pmesh.make_mesh(device_type=ctx.device.type)
    hybrid = pmesh.make_mesh(ctx.world_size, ("data", "model"), (1, ctx.world_size),
                             device_type=ctx.device.type)
    try:
        pmesh.make_mesh(ctx.world_size, ("data", "model"), (ctx.world_size, 2))
        bad = ""
    except ValueError as e:
        bad = str(e)
    return {"default": (tuple(default.shape), default.mesh_dim_names),
            "hybrid": (tuple(hybrid.shape), hybrid.mesh_dim_names),
            "coords": pmesh.batch_sharding(default, "data"),
            "replicated": [type(p).__name__ for p in pmesh.replicated(hybrid)],
            "rows": pmesh.shard_batch(batch, default)["m"]["data"],
            "bad_shape": bad}


def check_rank(ctx: Rank, fail_rank: int, how: str) -> int:
    """A rank function for checking the launcher: rank ``fail_rank`` raises
    (``how`` "raise") or never joins the barrier that the others wait in
    ("hang"); the others return their rank."""
    import time
    import torch.distributed as dist
    if ctx.rank == fail_rank:
        if how == "raise":
            raise ValueError(f"rank {ctx.rank} raised on purpose")
        time.sleep(3600)
    elif how == "hang":
        dist.barrier()
    return ctx.rank


def dryrun_job(n: int) -> StepJob:
    """The reference's dry-run step on ``n`` devices."""
    if n % 2 == 0 and n >= 4:
        shape, axes, sharding = (n // 2, 2), ("data", "model"), "megatron"
    else:
        shape, axes, sharding = (n,), ("data",), None
    return StepJob(specs=flagship_specs(12), batch=flagship_batch(2 * shape[0], 12),
                   n_latents=8, shape=shape, axes=axes, sharding=sharding, min_size=1024,
                   grad_accum=2, optimizer="adam", lr=1e-3)


def _dryrun_rank(ctx: Rank, n: int) -> Tuple[float, str]:
    job = dryrun_job(n)
    out = train_step_on_mesh(ctx, job)
    loss = out["metrics"]["loss"]
    if not math.isfinite(loss):
        raise FloatingPointError(f"dryrun loss not finite: {loss}")
    return loss, (f"dryrun_multichip OK: mesh={dict(zip(job.axes, job.shape))}, "
                  f"grad_accum=2, loss={loss:.2f}, step=1")


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     backend: Optional[str] = None, deadline: Optional[float] = 600.0) -> float:
    """Start ``n_devices`` ranks, run the dry-run step in them, print rank
    0's line and return the loss (see the module docstring)."""
    results = launch(_dryrun_rank, n_devices, n_devices, device=device, backend=backend,
                     deadline=deadline)
    loss, line = results[0]
    print(line)
    return loss


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="one sharded flagship train step")
    parser.add_argument("n", type=int, nargs="?", default=8)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--backend", default=None, help="nccl or gloo")
    args = parser.parse_args(sys.argv[1:])
    dryrun_multichip(args.n, device=args.device, backend=args.backend)
