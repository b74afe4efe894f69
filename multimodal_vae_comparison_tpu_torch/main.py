"""CLI entry point of the port (counterpart of ``main.py``):

    python -m multimodal_vae_comparison_tpu_torch.main --cfg <config>.yml [overrides]

The JAX package's flags (a YAML config selected with ``--cfg``, flags
replacing the config keys they name, an ``iterseeds`` loop that trains one
model per consecutive seed) plus ``--device`` (default: the card; ``cpu``
runs the plain PyTorch path).  The run directory is
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
                        help="numeric precision (bf16 is not ported yet)")
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
    parser.add_argument("--num_devices", type=int, default=None)
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
    print(f"Model: {type(trainer.model).__name__}, params: {trainer.n_params():,}, "
          f"device: {trainer.device}")
    trainer.fit()
    stats = trainer.test()
    if stats:
        print("test:", {k: round(v, 4) if isinstance(v, float) else v
                        for k, v in stats.items()})
    return trainer


def _profile_first_epoch(config, args):
    """A Trainer whose first epoch ran under ``torch.profiler``; its trace
    goes to ``args.profile``/trace.json.  ``fit`` goes on after that epoch."""
    from torch.profiler import ProfilerActivity, profile

    from multimodal_vae_comparison_tpu_torch.training.trainer import Trainer
    trainer = Trainer(config, device=args.device, enable_viz=not args.no_viz)
    trainer.init_state()
    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        trainer.fit(epochs=1)
    os.makedirs(args.profile, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    return trainer


def cli(argv=None):
    from multimodal_vae_comparison_tpu_torch.config import Config

    args = build_parser().parse_args(argv)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("cfg", "no_viz", "profile", "debug_nans", "device")}
    config = Config(args.cfg, overrides=overrides)
    # multi-seed iteration (reference main.py:56-67) on one Trainer
    trainer = None
    base_seed = config.seed
    for it in range(int(getattr(config, "iterseeds", 1))):
        print(f"### Training model {it + 1}/{config.iterseeds} (seed {config.seed})")
        if args.profile and trainer is None:
            trainer = _profile_first_epoch(config, args)
        trainer = main(config, enable_viz=not args.no_viz, trainer=trainer,
                       device=args.device)
        if it + 1 < config.iterseeds:
            config.change_seed(base_seed + it + 1)
            version_dir = os.path.join(config.results_root, config.exp_name,
                                       f"version_{config.find_version()}")
            trainer.reset_for_seed(config.seed, mPath=version_dir)
    return trainer


if __name__ == "__main__":
    cli(sys.argv[1:])
