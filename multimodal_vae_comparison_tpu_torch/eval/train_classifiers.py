"""CLI to train the benchmark judges again (counterpart of
``eval/train_classifiers.py``):

    python -m multimodal_vae_comparison_tpu_torch.eval.train_classifiers \
        --dataset cdspritesplus --path data/level2/traindata.h5 --level 2

    python -m multimodal_vae_comparison_tpu_torch.eval.train_classifiers \
        --dataset sprites --path data/sprites

CdSprites+: one judge per attribute of the level, saved under the name the
eval loads (``cdspritesplus_classifier_level{L}_{att}_v2.pt``).  SPRITES:
the action judge, a ``VideoClassifier`` saved as ``sprites_action_clf_v2.pt``
as the JAX package's CLI does (its eval trains and reads an
``ActionVideoClassifier`` as ``_v3``, and the attribute judge, itself).
Each is trained on 85 % of the given training data and scored on the other
15 % (a judge scored on its own training rows reads high).  Give it the
TRAINING data: the eval calibrates on the test or val rows, which must stay
apart from it.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from multimodal_vae_comparison_tpu_torch.device import resolve_device, set_numerics
from multimodal_vae_comparison_tpu_torch.eval.classifiers import (
    CLASSIFIER_DIR, CNNClassifier, VideoClassifier, classifier_accuracy, save_classifier,
    train_classifier)


def _holdout_split(n: int, seed: int = 0):
    """85/15 train/holdout index split for the printed accuracy."""
    order = np.random.default_rng(seed).permutation(n)
    n_hold = max(1, int(0.15 * n))
    return order[n_hold:], order[:n_hold]


def train_cdsprites(path: str, level: int, out_dir: str, device=None) -> dict:
    """Train and save the level's judges; returns {attribute: holdout accuracy}."""
    from multimodal_vae_comparison_tpu_torch.data.datasets import CDSPRITESPLUS
    from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import (
        CLASS_MAPPINGS, LEVEL_ATTRIBUTES, get_attribute)
    device = resolve_device(device)
    img_ds = CDSPRITESPLUS(path, None, "image")
    images, _ = img_ds.get_data("train")
    images = images.astype(np.float32)
    texts = [" ".join(l) if isinstance(l, (list, tuple)) else str(l)
             for l in img_ds.labels()]
    tr, ho = _holdout_split(len(images))
    accs = {}
    for att in LEVEL_ATTRIBUTES[level]:
        classes = CLASS_MAPPINGS[att]
        y = np.array([classes.index(get_attribute(att, t)) for t in texts])
        model = CNNClassifier(num_classes=len(classes)).to(device)
        train_classifier(model, images[tr], y[tr], log_fn=print)
        accs[att] = classifier_accuracy(model, images[ho], y[ho])
        out = os.path.join(out_dir, f"cdspritesplus_classifier_level{level}_{att}_v2.pt")
        save_classifier(model, out)
        print(f"{att}: holdout acc {accs[att]:.3f} -> {out}")
    return accs


def train_sprites(path: str, out_dir: str, device=None) -> float:
    """Train and save the SPRITES action judge from the train shards in
    ``path``; returns its holdout accuracy."""
    from multimodal_vae_comparison_tpu_torch.data.datasets import SPRITES
    device = resolve_device(device)
    frames, _ = SPRITES(path, None, "frames").get_data("train")
    actions, _ = SPRITES(path, None, "actions").get_data("train")
    frames = frames.astype(np.float32)
    y = np.argmax(actions, -1)
    tr, ho = _holdout_split(len(frames))
    model = VideoClassifier(num_classes=9, in_channels=frames.shape[-1]).to(device)
    train_classifier(model, frames[tr], y[tr], log_fn=print)
    acc = classifier_accuracy(model, frames[ho], y[ho])
    out = os.path.join(out_dir, "sprites_action_clf_v2.pt")
    save_classifier(model, out)
    print(f"actions: holdout acc {acc:.3f} -> {out}")
    return acc


def main(argv=None):
    set_numerics()
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True, choices=["cdspritesplus", "sprites"])
    parser.add_argument("--path", required=True)
    parser.add_argument("--level", type=int, default=1)
    parser.add_argument("--out_dir", default=CLASSIFIER_DIR)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; cpu for the plain path)")
    args = parser.parse_args(argv)
    if args.dataset == "sprites":
        return train_sprites(args.path, args.out_dir, device=args.device)
    return train_cdsprites(args.path, args.level, args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
