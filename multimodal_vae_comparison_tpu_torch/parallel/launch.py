"""Start N ranks of a ``torch.distributed`` process group and run one
function in each.

The JAX package drives every device from one process; PyTorch runs a
process per device.  :func:`launch` starts them:

    results = launch(fn, 2, arg, device="cpu")     # [fn(ctx0, arg), fn(ctx1, arg)]

* each rank is a fresh process (``spawn``) whose device is ``cuda:r`` (of
  the visible cards, in turn) or the CPU when the caller asks for it; ``fn``
  must be importable (a module-level function) and gets a :class:`Rank`;
* the backend is NCCL on the card and gloo on the CPU, or the one the
  caller names (gloo runs several ranks on one card, NCCL refuses that);
* the ranks meet through a file in a fresh temporary directory, never a
  fixed port;
* the process group has a ``timeout`` on every collective, and the parent
  a ``deadline`` after which it kills every rank and raises, so that a hung
  collective fails its caller instead of hanging it;
* an exception in any rank ends the whole launch with that rank's
  traceback;
* on the card the CUDA kernels are built in the parent, before any rank
  starts, so that no two ranks build the same library.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_vae_comparison_tpu_torch.device import set_numerics


@dataclasses.dataclass(frozen=True)
class Rank:
    """What a rank's function is given: its rank, the world size, its device
    and the process group's backend."""

    rank: int
    world_size: int
    device: torch.device
    backend: str


def _rank_main(rank: int, world: int, inbox, device_type: str, backend: str,
               init_file: str, timeout_s: float, out) -> None:
    # a spawned rank is a fresh process: it inherits none of the parent's flags
    set_numerics()
    if device_type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    try:
        fn, args = inbox.get()
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(Rank(rank, world, device, backend), *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put(("error", rank, traceback.format_exc()))
        raise
    out.put(("ok", rank, result))


def launch(fn: Callable, world_size: int, *args: Any, device: Optional[str] = None,
           backend: Optional[str] = None, timeout: float = 600.0,
           deadline: Optional[float] = None) -> List[Any]:
    """Run ``fn(Rank, *args)`` on ``world_size`` ranks and return their
    results in rank order.

    :param device: ``"cuda"`` (default) or ``"cpu"``; the card is not
        replaced by the CPU when it is missing
    :param backend: the process group's backend, default NCCL on the card
        and gloo on the CPU
    :param timeout: seconds any collective may wait
    :param deadline: seconds the whole launch may take (None: no limit);
        past it every rank is killed and ``TimeoutError`` raised
    """
    device_type = torch.device(device or "cuda").type
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                               "launch the ranks on the CPU")
        if backend == "nccl" and world_size > torch.cuda.device_count():
            raise ValueError(f"NCCL runs one rank a card: {world_size} ranks, "
                             f"{torch.cuda.device_count()} cards")
        from multimodal_vae_comparison_tpu_torch.ops.kernels import _build
        _build.build()
    elif backend == "nccl":
        raise ValueError("NCCL needs the card; the CPU's backend is gloo")
    ctx = mp.get_context("spawn")
    # the function and its arguments go through a queue, whose writes never
    # block the parent (a rank that dies before reading a large argument
    # from its start-up pipe would block the parent's start())
    inbox, out = ctx.Queue(), ctx.Queue()
    for _ in range(world_size):
        inbox.put((fn, args))
    tmp = tempfile.mkdtemp(prefix="mmvae_launch_")
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, inbox, device_type, backend, init_file,
                               timeout, out))
             for r in range(world_size)]
    ends = None if deadline is None else time.monotonic() + deadline
    results = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world_size:
            if ends is not None and time.monotonic() > ends:
                raise TimeoutError(f"{world_size} ranks of {getattr(fn, '__name__', fn)} "
                                   f"did not end within {deadline} s")
            try:
                status, rank, value = out.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead and out.empty():
                    r, code = dead[0]
                    raise RuntimeError(f"rank {r} of {world_size} exited with code "
                                       f"{code} and no result")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        for q in (inbox, out):
            q.cancel_join_thread()
            q.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world_size)]
