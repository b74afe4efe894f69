"""MNIST-SVHN pair builder (counterpart of ``data_proc/mnistsvhn.py``).

A copy of the JAX package's builder (the port imports nothing of that
package).  The reference pairs each MNIST digit with 20 random same-label
SVHN digits, both downloaded through torchvision.  Without a download two
paths:

* ``build_from_npz``: pairs *real* MNIST/SVHN arrays from ``mnist_raw.npz``
  / ``svhn_raw.npz`` (keys 'data', 'labels') in a directory, the reference
  protocol;
* ``build_surrogate``: an offline stand-in from the 8x8 digits of
  ``data_proc/digits.py`` (upscaled 28x28 "MNIST"; coloured, cluttered
  32x32 renders as "SVHN"), the same file contract and pairing, marked by a
  ``SURROGATE.txt``: its numbers are not comparable to published
  MNIST-SVHN results.

From the same seed both write the JAX builder's files byte for byte: the
same cv2 calls and numpy ``Generator`` draws in the same order.  Output
(what ``data/datasets.MNIST_SVHN`` loads): per-split index files
``{mnist,svhn}_idx_{train,test}.npy`` and ``mnist.npz`` / ``svhn.npz``
(keys 'data', 'labels') beside them.

    python -m multimodal_vae_comparison_tpu_torch.data_proc.mnistsvhn --out ./data/mnist_svhn
"""
from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np

from multimodal_vae_comparison_tpu_torch.data_proc.digits import load_digits


def pair_indices(labels_a: np.ndarray, labels_b: np.ndarray, pairs: int,
                 rng) -> Tuple[np.ndarray, np.ndarray]:
    """Reference pairing: for each class, take min-count x pairs shuffled
    matches (MMVAE's rand_match_on_idx)."""
    idx_a, idx_b = [], []
    for d in range(10):
        a = np.where(labels_a == d)[0]
        b = np.where(labels_b == d)[0]
        n = min(len(a), len(b))
        if n == 0:
            continue
        for _ in range(pairs):
            idx_a.append(rng.permutation(a)[:n])
            idx_b.append(rng.permutation(b)[:n])
    return np.concatenate(idx_a), np.concatenate(idx_b)


def _digits_as_mnist(images: np.ndarray, rng) -> np.ndarray:
    """8x8 digits (0..16) -> 28x28x1 uint8 with small affine jitter."""
    import cv2
    out = np.zeros((len(images), 28, 28, 1), np.uint8)
    for i, img in enumerate(images):
        big = cv2.resize((img / 16.0 * 255).astype(np.uint8), (24, 24),
                         interpolation=cv2.INTER_CUBIC)
        dx, dy = rng.integers(0, 5, 2)
        canvas = np.zeros((28, 28), np.uint8)
        canvas[dy:dy + 24, dx:dx + 24] = big
        out[i, :, :, 0] = canvas
    return out


def _digits_as_svhn(images: np.ndarray, rng) -> np.ndarray:
    """8x8 digits -> 32x32x3 uint8 street-number-style renders: colored
    glyph on a colored background with side distractor digit crops."""
    import cv2
    n = len(images)
    out = np.zeros((n, 32, 32, 3), np.uint8)
    for i, img in enumerate(images):
        bg = rng.integers(20, 120, 3)
        fg = rng.integers(120, 256, 3)
        canvas = np.ones((32, 32, 3), np.float32) * bg[None, None]
        glyph = cv2.resize((img / 16.0).astype(np.float32), (20, 26),
                           interpolation=cv2.INTER_CUBIC)
        x = rng.integers(4, 9)
        y = rng.integers(2, 5)
        alpha = np.clip(glyph, 0, 1)[..., None]
        canvas[y:y + 26, x:x + 20] = (alpha * fg[None, None]
                                      + (1 - alpha) * canvas[y:y + 26, x:x + 20])
        # distractor digit halves at the borders (SVHN's cropped neighbors)
        if rng.random() < 0.7:
            j = rng.integers(0, n)
            d = cv2.resize((images[j] / 16.0).astype(np.float32), (14, 22))
            side = rng.integers(0, 2)
            dfg = rng.integers(100, 220, 3)
            sl = (slice(5, 27), slice(0, 7)) if side else (slice(5, 27),
                                                           slice(25, 32))
            part = d[:, 7:] if side else d[:, :7]
            canvas[sl] = (part[..., None] * dfg[None, None]
                          + (1 - part[..., None]) * canvas[sl])
        noise = rng.normal(0, 8, (32, 32, 3))
        out[i] = np.clip(canvas + noise, 0, 255).astype(np.uint8)
    return out


def _write(out_dir: str, mnist, mlab, svhn, slab, pairs_train: int,
           pairs_test: int, test_fraction: float, rng) -> None:
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "mnist.npz"), data=mnist, labels=mlab)
    np.savez(os.path.join(out_dir, "svhn.npz"), data=svhn, labels=slab)
    # per-modality split indices: real MNIST (60k) and SVHN (73k) are NOT
    # the same length, so one shared index range would drop or overrun
    n_test_m = int(len(mlab) * test_fraction)
    n_test_s = int(len(slab) * test_fraction)
    splits = {
        "test": (np.arange(n_test_m), np.arange(n_test_s)),
        "train": (np.arange(n_test_m, len(mlab)),
                  np.arange(n_test_s, len(slab))),
    }
    for tag, (base_m, base_s) in splits.items():
        pairs = pairs_train if tag == "train" else pairs_test
        ia, ib = pair_indices(mlab[base_m], slab[base_s], pairs, rng)
        np.save(os.path.join(out_dir, f"mnist_idx_{tag}.npy"), base_m[ia])
        np.save(os.path.join(out_dir, f"svhn_idx_{tag}.npy"), base_s[ib])


def build_surrogate(out_dir: str, pairs_train: int = 20, pairs_test: int = 5,
                    test_fraction: float = 0.2, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    d = load_digits()
    order = rng.permutation(len(d.target))
    images, labels = d.images[order], d.target[order].astype(np.int64)
    mnist = _digits_as_mnist(images, rng)
    svhn = _digits_as_svhn(images, rng)
    _write(out_dir, mnist, labels, svhn, labels, pairs_train, pairs_test,
           test_fraction, rng)
    with open(os.path.join(out_dir, "SURROGATE.txt"), "w") as f:
        f.write("Derived from sklearn load_digits — NOT real MNIST/SVHN.\n"
                "Pipeline-parity only; absolute numbers not comparable.\n")
    return out_dir


def build_from_npz(raw_dir: str, out_dir: str, pairs_train: int = 20,
                   pairs_test: int = 5, test_fraction: float = 0.2,
                   seed: int = 0) -> str:
    """Real-data path: expects mnist_raw.npz / svhn_raw.npz in raw_dir."""
    rng = np.random.default_rng(seed)
    m = np.load(os.path.join(raw_dir, "mnist_raw.npz"))
    s = np.load(os.path.join(raw_dir, "svhn_raw.npz"))
    mnist = m["data"].reshape(-1, 28, 28, 1)
    svhn = s["data"]
    if svhn.shape[1] == 3:
        svhn = svhn.transpose(0, 2, 3, 1)
    _write(out_dir, mnist, m["labels"].astype(np.int64), svhn,
           s["labels"].astype(np.int64), pairs_train, pairs_test,
           test_fraction, rng)
    return out_dir


def main():
    p = argparse.ArgumentParser(description="Build the MNIST-SVHN pairing")
    p.add_argument("--out", required=True)
    p.add_argument("--raw_dir", default=None,
                   help="dir with mnist_raw.npz/svhn_raw.npz (real data); "
                        "omitted -> the 8x8-digits surrogate")
    p.add_argument("--pairs", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if args.raw_dir:
        d = build_from_npz(args.raw_dir, args.out, args.pairs, seed=args.seed)
    else:
        d = build_surrogate(args.out, args.pairs, seed=args.seed)
    print(f"MNIST-SVHN pairing -> {d}")


if __name__ == "__main__":
    main()
