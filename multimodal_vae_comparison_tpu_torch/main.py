"""CLI entry point of the port (counterpart of ``main.py``):

    python -m multimodal_vae_comparison_tpu_torch.main --cfg <config>.yml [overrides]

The JAX package's flags (a YAML config selected with ``--cfg``, flags
replacing the config keys they name, an ``iterseeds`` loop that trains one
model per consecutive seed) plus ``--device`` (default: the card; ``cpu``
runs the plain PyTorch path).  ``--num_devices N`` (default: every card,
one on the CPU; shrunk until it divides the batch size) trains data
parallel on N ranks started by ``parallel/launch.py``: NCCL on the cards,
one a rank (more than the host has raises), gloo on the CPU
(``--device cpu --num_devices 2``).  The run directory is
``<results_root>/<exp_name>/version_N`` with ``config.yml``,
``metrics.csv``, ``tb/`` and ``model/{last,best}/state.pt``.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="PyTorch multimodal VAE training")
    parser.add_argument("--cfg", type=str, required=True, help="path to the YAML config")
    parser.add_argument("--precision", type=str, default=None,
                        choices=["64", "32", "16", "bf16"],
                        help="compute precision: bf16 runs the nets in bf16 (parameters, "
                             "optimizer and eval stay fp32); 64, 32 and 16 run fp32")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--n_latents", type=int, default=None)
    parser.add_argument("--obj", type=str, default=None)
    parser.add_argument("--mixing", type=str, default=None)
    parser.add_argument("--beta", type=float, default=None)
    parser.add_argument("--K", type=int, default=None)
    parser.add_argument("--viz_freq", type=int, default=None)
    parser.add_argument("--exp_name", type=str, default=None)
    parser.add_argument("--optimizer", type=str, default=None)
    parser.add_argument("--num_devices", type=int, default=None,
                        help="ranks to train on, data parallel (default: every card; "
                             "one on the CPU)")
    parser.add_argument("--pre_trained", type=str, default=None,
                        help="run dir to warm-start parameters from")
    parser.add_argument("--no_viz", action="store_true")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler trace of the first epoch "
                             "into DIR/trace.json")
    parser.add_argument("--debug_nans", action="store_true",
                        help="torch.autograd.set_detect_anomaly(True): raise at "
                             "the op whose backward makes a NaN")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; cpu for the plain path)")
    return parser


def main(config, enable_viz: bool = True, trainer=None, device=None):
    """Train one model from a parsed Config and test it (reference
    main.py:41-54); pass an existing ``trainer`` to go on with it (the
    iterseeds path)."""
    from multimodal_vae_comparison_tpu_torch.training.trainer import Trainer

    if trainer is None:
        trainer = Trainer(config, device=device, enable_viz=enable_viz)
        trainer.init_state()
    if trainer.rank == 0:
        print(f"Model: {type(trainer.model).__name__}, params: {trainer.n_params():,}, "
              f"device: {trainer.device}, devices: {trainer.world}")
    trainer.fit()
    stats = trainer.test()
    if stats and trainer.rank == 0:
        print("test:", {k: round(v, 4) if isinstance(v, float) else v
                        for k, v in stats.items()})
    return trainer


def _profile_first_epoch(config, args, device=None):
    """A Trainer whose first epoch ran under ``torch.profiler``; its trace
    goes to ``args.profile``/trace.json (rank r's to ``trace_r<r>.json``).
    ``fit`` goes on after that epoch."""
    from torch.profiler import ProfilerActivity, profile

    from multimodal_vae_comparison_tpu_torch.training.trainer import Trainer
    trainer = Trainer(config, device=device, enable_viz=not args.no_viz)
    trainer.init_state()
    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        trainer.fit(epochs=1)
    os.makedirs(args.profile, exist_ok=True)
    name = "trace.json" if trainer.rank == 0 else f"trace_r{trainer.rank}.json"
    prof.export_chrome_trace(os.path.join(args.profile, name))
    return trainer


def cli(argv=None):
    """Train from the command line; returns the Trainer of the last seed (on
    N ranks, None: the ranks' Trainers end with their processes)."""
    from multimodal_vae_comparison_tpu_torch.config import Config
    from multimodal_vae_comparison_tpu_torch.device import set_numerics
    from multimodal_vae_comparison_tpu_torch.training.trainer import data_parallel_size

    set_numerics()
    args = build_parser().parse_args(argv)
    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("cfg", "no_viz", "profile", "debug_nans", "device")}
    config = Config(args.cfg, overrides=overrides)
    n = data_parallel_size(config, args.device)
    if n == 1:
        config.num_devices = 1
        return _train_seeds(config, args)
    from multimodal_vae_comparison_tpu_torch.parallel.launch import launch
    config.num_devices = n
    launch(_train_rank, n, config, args, device=args.device or "cuda")
    return None


def _train_rank(ctx, config, args) -> None:
    _train_seeds(config, args, device=ctx.device).close()


def _train_seeds(config, args, device=None):
    """The iterseeds loop (reference main.py:56-67) on one Trainer, in this
    process or in each rank of a process group."""
    import torch.distributed as dist

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    device = args.device if device is None else device
    rank = dist.get_rank() if dist.is_initialized() else 0
    trainer = None
    base_seed = config.seed
    for it in range(int(getattr(config, "iterseeds", 1))):
        if rank == 0:
            print(f"### Training model {it + 1}/{config.iterseeds} (seed {config.seed})")
        if args.profile and trainer is None:
            trainer = _profile_first_epoch(config, args, device)
        trainer = main(config, enable_viz=not args.no_viz, trainer=trainer, device=device)
        if it + 1 < config.iterseeds:
            config.change_seed(base_seed + it + 1)
            version_dir = [os.path.join(config.results_root, config.exp_name,
                                        f"version_{config.find_version()}")]
            if dist.is_initialized():   # rank 0's directory, which it makes
                dist.broadcast_object_list(version_dir, src=0)
            trainer.reset_for_seed(config.seed, mPath=version_dir[0])
    return trainer


if __name__ == "__main__":
    cli(sys.argv[1:])
