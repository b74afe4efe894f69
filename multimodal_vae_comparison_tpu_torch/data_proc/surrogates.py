"""Offline surrogates of the downloaded datasets (counterpart of
``data_proc/surrogates.py``).

A copy of the JAX package's builders (the port imports nothing of that
package): CelebA, FashionMNIST and CUB are downloads, so each family gets a
procedural surrogate with the real data's file contract, modality shapes
and factor structure, so that every stage (loaders, training, cross and
joint eval) runs without a download.  From the same seed it writes the same
arrays, captions and ``SURROGATE.txt`` as the JAX package.  Numbers on a
surrogate are NOT comparable to published results; each output directory
carries a ``SURROGATE.txt`` that says so.  ``cv2`` is imported where an
image is drawn.

* CelebA:       images (N,64,64,3) uint8 + atts (N,4) in {-1,1}
                (bald/eyeglasses/male/smiling — reference datasets.py:660)
* FashionMNIST: fashionmnist.npz  data (N,28,28) uint8, labels (N,), and
                test/fashionmnist.npz
* CUB:          images (N,64,64,3) uint8 + captions list[str] pkl

    python -m multimodal_vae_comparison_tpu_torch.data_proc.surrogates cub \
        --out ./data/cub --train 6000 --test 800
    python -m multimodal_vae_comparison_tpu_torch.data_proc.surrogates fashionmnist \
        --out ./data/fashionmnist
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def _note(out_dir: str, text: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "SURROGATE.txt"), "w") as f:
        f.write(text + "\nPipeline-parity only; absolute numbers are not "
                "comparable to the real dataset.\n")


# -- CelebA ------------------------------------------------------------------

def _render_face(rng, atts) -> np.ndarray:
    """64x64 cartoon face whose appearance is determined by the 4 binary
    attributes (bald, eyeglasses, male, smiling)."""
    import cv2
    bald, glasses, male, smiling = atts
    img = np.full((64, 64, 3), 0, np.uint8)
    img[:] = rng.integers(100, 220, 3)  # background
    skin = tuple(int(v) for v in rng.integers(150, 230, 3))
    cx, cy = 32 + rng.integers(-3, 4), 34 + rng.integers(-3, 4)
    w = 14 + (3 if male else 0) + rng.integers(-1, 2)
    h = 18 + rng.integers(-1, 2)
    cv2.ellipse(img, (cx, cy), (w, h), 0, 0, 360, skin, -1)
    if not bald:
        hair = tuple(int(v) for v in rng.integers(0, 120, 3))
        cv2.ellipse(img, (cx, cy - h + 4), (w, 8 + rng.integers(0, 4)),
                    0, 180, 360, hair, -1)
    eye_y = cy - 4
    for ex in (cx - 6, cx + 6):
        cv2.circle(img, (ex, eye_y), 2, (30, 30, 30), -1)
        if glasses:
            cv2.rectangle(img, (ex - 4, eye_y - 4), (ex + 4, eye_y + 3),
                          (10, 10, 10), 1)
    if glasses:
        cv2.line(img, (cx - 2, eye_y - 1), (cx + 2, eye_y - 1),
                 (10, 10, 10), 1)
    my = cy + 8
    if smiling:
        cv2.ellipse(img, (cx, my - 2), (5, 4), 0, 20, 160, (60, 20, 20), 2)
    else:
        cv2.line(img, (cx - 4, my), (cx + 4, my), (60, 20, 20), 2)
    if male:
        cv2.rectangle(img, (cx - w + 2, cy + h - 4), (cx + w - 2, cy + h),
                      skin, -1)
    noise = rng.normal(0, 6, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def build_celeba(out_dir: str, n_train: int = 8000, n_test: int = 1000,
                 seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    _note(out_dir, "Procedural cartoon faces — NOT real CelebA. Attributes "
          "(bald, eyeglasses, male, smiling) causally control the render.")
    for tag, n in (("", n_train), ("test_", n_test)):
        atts = rng.integers(0, 2, (n, 4))
        imgs = np.stack([_render_face(rng, a) for a in atts])
        np.save(os.path.join(out_dir, f"{tag}images.npy"), imgs)
        # reference attr files are {-1,1} (datasets.py:683)
        np.save(os.path.join(out_dir, f"{tag}atts.npy"),
                (atts * 2 - 1).astype(np.float32))
    return out_dir


# -- FashionMNIST ------------------------------------------------------------

def _render_garment(rng, cls: int) -> np.ndarray:
    """28x28 grayscale silhouette for one of the 10 FashionMNIST classes."""
    import cv2
    img = np.zeros((28, 28), np.float32)
    j = lambda k=2: int(rng.integers(-k, k + 1))
    v = float(rng.uniform(0.7, 1.0))
    if cls in (0, 2, 4, 6):  # tshirt / pullover / coat / shirt: torso+sleeves
        cv2.rectangle(img, (9 + j(), 8 + j()), (19 + j(), 24 + j()), v, -1)
        sleeve = {0: 3, 2: 6, 4: 8, 6: 5}[cls]
        cv2.rectangle(img, (4 + j(1), 8 + j(1)), (9, 8 + sleeve + j(1)), v, -1)
        cv2.rectangle(img, (19, 8 + j(1)), (24 + j(1), 8 + sleeve + j(1)), v, -1)
        if cls == 6:  # shirt: button line
            img[10:24, 14] = 0.2
    elif cls == 1:  # trousers: two legs
        cv2.rectangle(img, (9 + j(1), 6 + j()), (13, 25 + j(1)), v, -1)
        cv2.rectangle(img, (15, 6 + j()), (19 + j(1), 25 + j(1)), v, -1)
        cv2.rectangle(img, (9, 6), (19, 10), v, -1)
    elif cls == 3:  # dress: flared trapezoid
        pts = np.array([[12 + j(1), 5 + j(1)], [16 + j(1), 5],
                        [21 + j(1), 25], [7 + j(1), 25 + j(1)]])
        cv2.fillPoly(img, [pts], v)
    elif cls in (5, 7, 9):  # sandal / sneaker / boot
        hh = {5: 3, 7: 6, 9: 12}[cls]
        cv2.rectangle(img, (5 + j(1), 22 - hh + j(1)), (23 + j(1), 24), v, -1)
        if cls == 9:
            cv2.rectangle(img, (5, 10 + j(1)), (14, 24), v, -1)
        if cls == 5:
            img[18:22, 8:21:4] = 0.0  # straps
    else:  # bag
        cv2.rectangle(img, (6 + j(1), 12 + j(1)), (22 + j(1), 24 + j(1)), v, -1)
        cv2.ellipse(img, (14 + j(1), 12), (5, 4), 0, 180, 360, v, 2)
    img += rng.normal(0, 0.03, img.shape)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def build_fashionmnist(out_dir: str, n_train: int = 10000,
                       n_test: int = 2000, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    _note(out_dir, "Procedural garment silhouettes — NOT real FashionMNIST.")
    for name, n in (("fashionmnist.npz", n_train),
                    ("test/fashionmnist.npz", n_test)):
        labels = rng.integers(0, 10, n)
        data = np.stack([_render_garment(rng, c) for c in labels])
        path = os.path.join(out_dir, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez(path, data=data, labels=labels.astype(np.int64))
    return out_dir


# -- CUB (birds + captions) --------------------------------------------------

_BIRD_COLORS = {"blue": (60, 90, 220), "red": (200, 50, 40),
                "yellow": (230, 210, 60), "brown": (140, 90, 50),
                "grey": (130, 130, 130), "white": (235, 235, 235)}
_BELLY = {"white": (240, 240, 240), "yellow": (230, 215, 80),
          "orange": (235, 140, 50)}


def _render_bird(rng, size, color, beak, belly) -> np.ndarray:
    import cv2
    img = np.zeros((64, 64, 3), np.uint8)
    sky = rng.integers(140, 230)
    img[:] = (sky // 2, sky, min(255, sky + 20))  # sky-ish
    cv2.rectangle(img, (0, 52 + int(rng.integers(0, 6))), (64, 64),
                  (40, 70, 30), -1)  # branch/ground
    s = 1.0 if size == "large" else 0.65
    cx, cy = 30 + int(rng.integers(-4, 5)), 34 + int(rng.integers(-4, 5))
    body = _BIRD_COLORS[color]
    bw, bh = int(14 * s), int(9 * s)
    cv2.ellipse(img, (cx, cy), (bw, bh), 0, 0, 360, body, -1)
    cv2.ellipse(img, (cx, cy + int(3 * s)), (int(bw * 0.7), int(bh * 0.6)),
                0, 0, 180, _BELLY[belly], -1)
    hx, hy = cx + int(12 * s), cy - int(8 * s)
    cv2.circle(img, (hx, hy), int(5 * s), body, -1)
    cv2.circle(img, (hx + int(2 * s), hy - 1), 1, (10, 10, 10), -1)
    blen = int((8 if beak == "long" else 4) * s)
    pts = np.array([[hx + int(4 * s), hy - 2], [hx + int(4 * s) + blen, hy],
                    [hx + int(4 * s), hy + 2]])
    cv2.fillPoly(img, [pts], (230, 160, 40))
    cv2.ellipse(img, (cx - int(2 * s), cy - int(2 * s)),
                (int(8 * s), int(5 * s)), -20, 0, 360,
                tuple(int(c * 0.7) for c in body), -1)  # wing
    cv2.line(img, (cx - bw, cy + int(2 * s)),
             (cx - bw - int(8 * s), cy + int(6 * s)), body, 2)  # tail
    noise = rng.normal(0, 5, img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def _bird_caption(rng, size, color, beak, belly) -> str:
    templates = [
        "this is a {size} {color} bird with a {beak} beak and a {belly} belly",
        "a {size} bird that is {color} with a {belly} belly and a {beak} beak",
        "the {color} bird is {size} and has a {beak} beak",
    ]
    t = templates[int(rng.integers(0, len(templates)))]
    return t.format(size=size, color=color, beak=beak, belly=belly)


def build_cub(out_dir: str, n_train: int = 6000, n_test: int = 800,
              seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    _note(out_dir, "Procedural birds + grammar captions — NOT real CUB. "
          "Caption factors (size, color, beak, belly) control the render.")
    for tag, n in (("", n_train), ("test_", n_test)):
        imgs, caps = [], []
        for _ in range(n):
            size = ["small", "large"][int(rng.integers(0, 2))]
            color = list(_BIRD_COLORS)[int(rng.integers(0, len(_BIRD_COLORS)))]
            beak = ["short", "long"][int(rng.integers(0, 2))]
            belly = list(_BELLY)[int(rng.integers(0, len(_BELLY)))]
            imgs.append(_render_bird(rng, size, color, beak, belly))
            caps.append(_bird_caption(rng, size, color, beak, belly))
        np.save(os.path.join(out_dir, f"{tag}images.npy"), np.stack(imgs))
        with open(os.path.join(out_dir, f"{tag}captions.pkl"), "wb") as f:
            pickle.dump(caps, f)
    return out_dir


def main():
    p = argparse.ArgumentParser(description="Build offline surrogates")
    p.add_argument("family", choices=["celeba", "fashionmnist", "cub"])
    p.add_argument("--out", required=True)
    p.add_argument("--train", type=int, default=None)
    p.add_argument("--test", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    fn = {"celeba": build_celeba, "fashionmnist": build_fashionmnist,
          "cub": build_cub}[args.family]
    kw = {"seed": args.seed}
    if args.train:
        kw["n_train"] = args.train
    if args.test:
        kw["n_test"] = args.test
    print(f"{args.family} -> {fn(args.out, **kw)}")


if __name__ == "__main__":
    main()
