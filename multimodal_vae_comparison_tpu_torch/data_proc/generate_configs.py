"""Grid-search config generator (counterpart of
``data_proc/generate_configs.py``).

Takes a base YAML config and value lists of hyperparameters on the command
line and writes one numbered YAML per point of their cartesian product,
``config_<n>.yml``, each with an ``exp_name`` that names its point (the
reference's multimodal_compare/data_proc/generate_configs.py:44-67).  A
copy of the JAX package's generator: the same arguments write the same
files.

    python -m multimodal_vae_comparison_tpu_torch.data_proc.generate_configs \
        --cfg configs/config_cdspritesplus.yml --path grid/ \
        --mixing moe poe --lr 1e-4 5e-4 --n_latents 16 24
"""
from __future__ import annotations

import argparse
import copy
import itertools
import os

import yaml


GRID_KEYS = ["mixing", "lr", "n_latents", "beta", "obj", "batch_size",
             "epochs", "K", "optimizer", "seed"]


def generate(base_cfg: dict, grid: dict, out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    keys = list(grid.keys())
    count = 0
    for values in itertools.product(*(grid[k] for k in keys)):
        cfg = copy.deepcopy(base_cfg)
        for k, v in zip(keys, values):
            cfg[k] = v
        cfg["exp_name"] = "_".join(
            [str(base_cfg.get("exp_name", "grid"))]
            + [f"{k}{v}" for k, v in zip(keys, values)])
        with open(os.path.join(out_dir, f"config_{count}.yml"), "w") as f:
            yaml.dump(cfg, f, default_flow_style=False)
        count += 1
    return count


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True, help="base YAML config")
    parser.add_argument("--path", required=True, help="output directory")
    for key in GRID_KEYS:
        parser.add_argument(f"--{key}", nargs="+", default=None)
    args = parser.parse_args()
    with open(args.cfg) as f:
        base = yaml.safe_load(f)
    grid = {}
    for key in GRID_KEYS:
        vals = getattr(args, key)
        if vals:
            grid[key] = [yaml.safe_load(v) for v in vals]
    n = generate(base, grid, args.path)
    print(f"wrote {n} configs to {args.path}")


if __name__ == "__main__":
    main()
