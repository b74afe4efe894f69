"""Train a shipped CdSprites+ config through the port's CLI on the card, and
score it with the benchmark that ends every CLI run.

    python3 quality_run.py --cfg configs/round5/cdl1_r5_poe.yml --seed 1 \
        --out results/quality_run

Generates the config's CdSprites+ level with the port's generator (COUNT
rows, generator seed 0; ``.pkl`` where h5py is missing) into a temporary
directory, removed at the end, and writes a copy of the config pointing at
it with one seed (``iterseeds: 1``).  Then
``python -m multimodal_vae_comparison_tpu_torch.main --cfg <copy> --seed
<seed>`` runs in ``--out``: the config's epochs, then ``Trainer.test()``,
whose ``cdspritesplus_stats.txt`` lands in the run directory under
``<out>/results`` and whose judges are cached in ``<out>/judges`` (unless
``CDSPRITES_CLASSIFIER_DIR`` is set).  Prints the card's name and power
limit and the run's seconds.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
COUNT = 10000   # rows of the level: the generator's default


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default="configs/round5/cdl1_r5_poe.yml")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--out", default=os.path.join("results", "quality_run"))
    args = parser.parse_args(argv)
    sys.path.insert(0, HERE)
    import yaml

    from multimodal_vae_comparison_tpu_torch import main as port_main
    from multimodal_vae_comparison_tpu_torch.data_proc.cdsprites import generate_level

    with open(os.path.join(HERE, args.cfg)) as f:
        params = yaml.safe_load(f)
    level = next(lvl for lvl in range(1, 6) if f"level{lvl}" in params["modality_1"]["path"])
    try:
        import h5py  # noqa: F401
        fmt = "h5"
    except ImportError:
        fmt = "pkl"
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    os.environ.setdefault("CDSPRITES_CLASSIFIER_DIR", os.path.join(out, "judges"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"quality run: {args.cfg} seed {args.seed}, level {level} at {COUNT} rows, "
          f"{params['epochs']} epochs, on {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="quality_run_") as data_root:
        level_dir = generate_level(level, COUNT, data_root, seed=0, fmt=fmt)
        for key, block in params.items():
            if key.startswith("modality_"):
                block["path"] = os.path.join(level_dir, f"traindata.{fmt}")
                block["test_datapath"] = os.path.join(level_dir, f"testdata.{fmt}")
        params["iterseeds"] = 1
        cfg = os.path.join(data_root, os.path.basename(args.cfg))
        with open(cfg, "w") as f:
            yaml.safe_dump(params, f)
        cwd = os.getcwd()
        os.chdir(out)
        t0 = time.perf_counter()
        try:
            trainer = port_main.cli(["--cfg", cfg, "--seed", str(args.seed)])
        finally:
            os.chdir(cwd)
    run_dir = os.path.join(out, trainer.cfg.mPath)
    print(f"quality run: {time.perf_counter() - t0:.1f} s on {card}, run directory {run_dir}")
    return 0 if os.path.isfile(os.path.join(run_dir, "cdspritesplus_stats.txt")) else 1


if __name__ == "__main__":
    sys.exit(main())
