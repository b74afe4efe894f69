"""GeBiD dataset generator, the untextured CdSprites+ predecessor
(counterpart of ``data_proc/gebid.py``).

A copy of the JAX package's generator (the port imports nothing of that
package), with the reference's factor vocabulary and on-disk contract
(multimodal_compare/data_proc/generate_dataset.py):

* 6 shapes (line, circle, square, semicircle, pieslice, spiral), 12 colors,
  2 sizes, 2x2 locations, 2 backgrounds;
* per-level attribute filtering as the reference's ``text_to_level`` (L1
  shape; L2 size+shape; L3 +color; L4 +background; L5 +location);
* image rules: shapes are black below L3, sizes vary from L2, position is
  quadrant-coded only at L5, background varies from L4;
* output: ``attrs.pkl`` (level-filtered attribute lists) and
  ``image/img_N.png``, and with ``--h5`` a ``traindata.h5`` /
  ``testdata.h5`` pair (image uint8 NHWC + text bytes) that the DataModule
  trains on.

cv2 primitives draw the shapes, as in the JAX package, so one seed gives
the JAX generator's arrays and files; cv2 is imported where a shape is
drawn, h5py only with ``--h5``.

    python -m multimodal_vae_comparison_tpu_torch.data_proc.gebid --level 5 \
        --size 10000 --dir ./data/GeBiD/level5 --h5
"""
from __future__ import annotations

import argparse
import os
import pickle
from math import cos, pi, sin
from typing import List, Tuple

import numpy as np

SHAPES = ["line", "circle", "square", "semicircle", "pieslice", "spiral"]
COLORS = {"yellow": (255, 255, 0), "red": (255, 0, 0), "green": (0, 255, 0),
          "blue": (0, 0, 255), "grey": (128, 128, 128), "brown": (105, 0, 0),
          "purple": (215, 0, 215), "teal": (0, 175, 175), "navy": (0, 0, 150),
          "orange": (255, 140, 0), "beige": (232, 211, 185),
          "pink": (255, 182, 193)}
SIZES = ["small", "large"]
LOCATIONS1 = ["at the top", "at the bottom"]
LOCATIONS2 = ["left", "right"]
BACKGROUNDS = ["on white", "on black"]


def _draw_spiral(canvas, cx, cy, scale, color, step=0.5, loops=5):
    """Archimedean spiral r = a + b*theta as a cv2 polyline."""
    import cv2
    pts = []
    theta = 0.0
    while theta < 2 * loops * pi:
        r = scale * theta
        pts.append((int(cx + r * cos(theta)), int(cy + r * sin(theta))))
        theta += step
    cv2.polylines(canvas, [np.asarray(pts, np.int32)], False, color, 1)


def draw_shape(canvas: np.ndarray, shape: str, x: int, y: int, side: int,
               color: Tuple[int, int, int]) -> None:
    import cv2
    c = tuple(int(v) for v in color)
    if shape == "square":
        cv2.rectangle(canvas, (x, y), (x + side, y + side), c, -1)
    elif shape == "circle":
        r = side // 2
        cv2.circle(canvas, (x + r, y + r), r, c, -1)
    elif shape == "line":
        cv2.line(canvas, (x, y), (x + side, y + side),
                 c, max(side // 2, 1))
    elif shape == "semicircle":
        cv2.ellipse(canvas, (x + side // 2, y + side // 2),
                    (side // 2, side // 2), 0, 50, 270, c, -1)
    elif shape == "pieslice":
        cv2.ellipse(canvas, (x + side, y + side), (side, side),
                    0, 200, 250, c, -1)
    elif shape == "spiral":
        _draw_spiral(canvas, x, y, 0.6 if side > 20 else 0.3, c)
    else:
        raise ValueError(f"unknown GeBiD shape {shape}")


def make_attrs(rng, n: int) -> List[List[str]]:
    return [[rng.choice(SIZES), rng.choice(list(COLORS)), rng.choice(SHAPES),
             rng.choice(LOCATIONS1), rng.choice(LOCATIONS2),
             rng.choice(BACKGROUNDS)] for _ in range(n)]


def text_to_level(attrs: List[List[str]], level: int):
    """Per-level caption filtering (reference generate_dataset.py:95-100)."""
    filters = {
        1: lambda t: t[2],
        2: lambda t: [t[0], t[2]],
        3: lambda t: list(t[:3]),
        4: lambda t: list(t[:3]) + [t[-1]],
        5: lambda t: list(t[:3]) + [" ".join(t[3:5])] + [t[-1]],
    }
    return [filters[level](t) for t in attrs]


def render(rng, attrs: List[str], level: int, size: int = 64) -> np.ndarray:
    """Render one 64x64 RGB sample from a full attribute row."""
    size_name, color_name, shape, loc1, loc2, bkgr = attrs
    bg = (bkgr.split(" ")[-1] if level >= 4 else "white")
    canvas = np.full((size, size, 3),
                     255 if bg == "white" else 0, np.uint8)
    color = COLORS[color_name] if level >= 3 else (0, 0, 0)
    if level >= 3 and bg == "black" and color == (0, 0, 0):
        color = (40, 40, 40)
    if level > 1:
        side = 30 if size_name == "large" else 16
    else:
        side, size_name = 30, "large"
    if level == 5:
        x = rng.integers(5, 11) if "left" in loc2 else rng.integers(30, 36)
        y = rng.integers(5, 11) if "top" in loc1 else rng.integers(30, 36)
    else:
        x = 22 - side // 4 + rng.integers(-3, 4)
        y = 22 - side // 4 + rng.integers(-3, 4)
    draw_shape(canvas, shape, int(x), int(y), side, color)
    return canvas


def generate(level: int, n: int, out_dir: str, seed: int = 0,
             write_h5: bool = False, test_fraction: float = 0.1) -> str:
    """Write attrs.pkl + image/ pngs (reference contract), optionally h5."""
    import cv2
    rng = np.random.default_rng(seed + level)
    os.makedirs(os.path.join(out_dir, "image"), exist_ok=True)
    attrs = make_attrs(rng, n)
    with open(os.path.join(out_dir, "attrs.pkl"), "wb") as f:
        pickle.dump(np.asarray(text_to_level(attrs, level), dtype=object), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    imgs = np.zeros((n, 64, 64, 3), np.uint8)
    for i, row in enumerate(attrs):
        imgs[i] = render(rng, row, level)
        cv2.imwrite(os.path.join(out_dir, "image", f"img_{i:06d}.png"),
                    imgs[i][..., ::-1])  # RGB -> BGR for imwrite
    if write_h5:
        import h5py
        caps = [(" ".join(t) if isinstance(t, list) else t).encode("utf8")
                for t in text_to_level(attrs, level)]
        n_test = max(int(n * test_fraction), 1)
        for name, sl in (("traindata", slice(0, n - n_test)),
                         ("testdata", slice(n - n_test, n))):
            with h5py.File(os.path.join(out_dir, f"{name}.h5"), "w") as f:
                f.create_dataset("image", data=imgs[sl])
                f.create_dataset("text", data=np.array(caps[sl]))
    return out_dir


def main():
    parser = argparse.ArgumentParser(description="GeBiD data generator")
    parser.add_argument("--dir", default="./data/GeBiD/level5")
    parser.add_argument("--level", default=5, type=int,
                        choices=[1, 2, 3, 4, 5])
    parser.add_argument("--size", default=10000, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--h5", action="store_true",
                        help="also write traindata.h5/testdata.h5")
    args = parser.parse_args()
    d = generate(args.level, args.size, args.dir, args.seed, args.h5)
    print(f"GeBiD level {args.level}: {args.size} samples -> {d}")


if __name__ == "__main__":
    main()
