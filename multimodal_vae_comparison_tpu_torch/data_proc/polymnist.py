"""PolyMNIST builder (counterpart of ``data_proc/polymnist.py``): 5
digit-image modalities m0..m4 sharing the label.

A copy of the JAX package's builder (the port imports nothing of that
package).  The reference downloads the published PolyMNIST set (5 renders
of the same digit over 5 fixed background images).  Without a download two
paths, as in ``data_proc/mnistsvhn.py``:

* ``build_from_npz``: styles *real* MNIST digits from ``mnist_raw.npz``
  (keys 'data', 'labels');
* ``build_surrogate``: offline, from the 8x8 digits of
  ``data_proc/digits.py``.

Either way the construction is the published one: each sample pairs five
*different instances* of the same digit class, one per modality, each
composited over that modality's fixed background, so the digit identity is
the only factor the modalities share.  From the same seed both write the
JAX builder's files byte for byte.

Output (``data/datasets.POLYMNIST``): ``m{0..4}.npy`` uint8 (N, 28, 28, 3),
``test_m{0..4}.npy``, and ``labels.npy`` / ``test_labels.npy`` (the digit,
which ``eval/eval_polymnist.py`` scores).

    python -m multimodal_vae_comparison_tpu_torch.data_proc.polymnist --out ./data/polymnist
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from multimodal_vae_comparison_tpu_torch.data_proc.digits import load_digits


def _backgrounds(rng) -> np.ndarray:
    """Five fixed 28x28x3 background textures, one per modality — the
    surrogate for the reference's five background crops."""
    bgs = np.zeros((5, 28, 28, 3), np.float32)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32) / 27.0
    # m0: solid dark blue     m1: checkerboard        m2: horizontal gradient
    # m3: diagonal stripes    m4: noise texture
    bgs[0] = np.stack([0.1 * np.ones_like(xx), 0.15 * np.ones_like(xx),
                       0.45 * np.ones_like(xx)], -1)
    checker = ((np.floor(yy * 7) + np.floor(xx * 7)) % 2)[..., None]
    bgs[1] = checker * [0.5, 0.3, 0.1] + (1 - checker) * [0.15, 0.1, 0.05]
    bgs[2] = np.stack([xx * 0.6, 0.1 + 0.3 * xx, 0.5 - 0.4 * xx], -1)
    stripes = (((yy + xx) * 10).astype(int) % 2)[..., None]
    bgs[3] = stripes * [0.1, 0.4, 0.2] + (1 - stripes) * [0.3, 0.1, 0.3]
    bgs[4] = rng.random((28, 28, 3)).astype(np.float32) * 0.5
    return bgs


_FG = np.array([[1.0, 1.0, 1.0], [1.0, 0.9, 0.3], [0.4, 1.0, 0.6],
                [1.0, 0.5, 0.5], [0.6, 0.8, 1.0]], np.float32)


def _compose(glyphs28: np.ndarray, mod: int, bg: np.ndarray) -> np.ndarray:
    """Alpha-composite white-on-black 28x28 glyphs over modality mod's bg."""
    alpha = glyphs28[..., None]  # (N, 28, 28, 1) in [0,1]
    img = alpha * _FG[mod][None, None, None] + (1 - alpha) * bg[None]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _build(glyphs28: np.ndarray, labels: np.ndarray, out_dir: str,
           samples_train: int, samples_test: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    bgs = _backgrounds(rng)
    by_class = {d: np.where(labels == d)[0] for d in range(10)}
    by_class = {d: v for d, v in by_class.items() if len(v)}
    # split each class's glyph INSTANCES into disjoint train/test pools —
    # drawing both splits from one pool leaks training digits into test and
    # inflates every judged/classified test metric by memorization
    pools = {}
    for d, idx in by_class.items():
        idx = rng.permutation(idx)
        n_test_pool = max(1, int(0.15 * len(idx))) if len(idx) > 1 else 0
        pools[d] = {"test_": idx[:n_test_pool], "": idx[n_test_pool:]}
    for tag, n in (("", samples_train), ("test_", samples_test)):
        by_split = {d: p[tag] for d, p in pools.items() if len(p[tag])}
        classes = sorted(by_split)
        lab = rng.integers(0, 10, n)
        # absent labels (non-contiguous class sets) map onto a present class
        lab = np.array([d if d in by_split else classes[d % len(classes)]
                        for d in lab])
        # five different instances of the same class, one per modality
        # (without replacement whenever the class has >=5 members)
        picks = np.empty((5, n), np.int64)
        for j, d in enumerate(lab):
            pool = by_split[d]
            picks[:, j] = rng.choice(pool, size=5, replace=len(pool) < 5)
        for mod in range(5):
            imgs = _compose(glyphs28[picks[mod]], mod, bgs[mod])
            np.save(os.path.join(out_dir, f"{tag}m{mod}.npy"), imgs)
        np.save(os.path.join(out_dir, f"{tag}labels.npy"), lab)
    return out_dir


def _digit_glyphs(rng):
    """The 8x8 digits upscaled to 24x24 at a random offset in 28x28, in
    [0, 1], and their labels."""
    import cv2
    d = load_digits()
    glyphs = np.zeros((len(d.target), 28, 28), np.float32)
    for i, img in enumerate(d.images):
        big = cv2.resize((img / 16.0).astype(np.float32), (24, 24),
                         interpolation=cv2.INTER_CUBIC)
        dx, dy = rng.integers(0, 5, 2)
        glyphs[i, dy:dy + 24, dx:dx + 24] = big
    return np.clip(glyphs, 0, 1), d.target.astype(np.int64)


def build_surrogate(out_dir: str, samples_train: int = 10000,
                    samples_test: int = 2000, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    glyphs, labels = _digit_glyphs(rng)
    _build(glyphs, labels, out_dir, samples_train, samples_test, seed)
    with open(os.path.join(out_dir, "SURROGATE.txt"), "w") as f:
        f.write("Glyphs from sklearn load_digits — NOT real MNIST.\n"
                "PolyMNIST construction (5 same-class instances over 5 "
                "fixed backgrounds) is faithful; absolute numbers are not "
                "comparable to published PolyMNIST results.\n")
    return out_dir


def build_from_npz(raw_dir: str, out_dir: str, samples_train: int = 30000,
                   samples_test: int = 5000, seed: int = 0) -> str:
    m = np.load(os.path.join(raw_dir, "mnist_raw.npz"))
    glyphs = m["data"].reshape(-1, 28, 28).astype(np.float32)
    if glyphs.max() > 1.5:
        glyphs = glyphs / 255.0
    return _build(glyphs, m["labels"].astype(np.int64), out_dir,
                  samples_train, samples_test, seed)


def main():
    p = argparse.ArgumentParser(description="Build PolyMNIST (5 modalities)")
    p.add_argument("--out", required=True)
    p.add_argument("--raw_dir", default=None,
                   help="dir with mnist_raw.npz (real digits); omitted -> "
                        "the 8x8-digits surrogate")
    p.add_argument("--train", type=int, default=10000)
    p.add_argument("--test", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if args.raw_dir:
        d = build_from_npz(args.raw_dir, args.out, args.train, args.test,
                           args.seed)
    else:
        d = build_surrogate(args.out, args.train, args.test, args.seed)
    print(f"PolyMNIST -> {d}")


if __name__ == "__main__":
    main()
