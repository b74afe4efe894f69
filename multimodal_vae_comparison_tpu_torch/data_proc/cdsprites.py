"""CdSprites+ dataset generator, fully offline (counterpart of
``data_proc/cdsprites.py``).

A copy of the JAX package's generator (the port imports nothing of that
package): the sprites are rendered procedurally with cv2 primitives and
noise-octave textures, with the reference's factor vocabulary, caption
grammar, 5 difficulty levels and ``traindata.h5`` / ``testdata.h5`` output
(keys 'image' uint8 NHWC + 'text' bytes).  From the same seed it writes the
same arrays as the JAX generator.  ``cv2`` and ``h5py`` are imported where
they are used.

    python -m multimodal_vae_comparison_tpu_torch.data_proc.cdsprites \
        --level 1 --count 10000 --out_dir ./data/CdSpritesplus

Levels (reference config_levelN.json; shapes are textured from level 3, the
background from level 5):
  1: shape                              "square"
  2: + size                            "big square"
  3: + color (textured shapes)         "big red square"
  4: + position                        "big red square at top left"
  5: + background (textured)           "... on dark"
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import List, Tuple

import numpy as np

# benchmark vocabulary: must match the JAX package's eval/eval_cdsprites.py
COLORS = {"white": (255, 255, 255), "red": (192, 64, 0),
          "yellow": (228, 217, 111), "green": (10, 107, 60),
          "blue": (0, 127, 200), "pink": (255, 0, 255)}
SHAPES = ["square", "ellipse", "heart"]
SIZES = {"big": 22, "small": 12}
POSITIONS = {"at top left": (18, 18), "at top right": (46, 18),
             "at bottom left": (18, 46), "at bottom right": (46, 46)}
BACKGROUNDS = {"on light": 210, "on dark": 60}
LEVEL_COLORS = ["red", "yellow", "green", "blue", "pink"]


def _noise_texture(rng, base: int, size: int = 64, amp: int = 45) -> np.ndarray:
    """Multi-octave value-noise texture around a base brightness."""
    import cv2
    acc = np.zeros((size, size), np.float32)
    for octave in (4, 8, 16):
        g = rng.standard_normal((octave, octave)).astype(np.float32)
        acc += cv2.resize(g, (size, size), interpolation=cv2.INTER_LINEAR)
    acc = acc / np.abs(acc).max() * amp
    return np.clip(base + acc, 0, 255).astype(np.uint8)


def _draw_shape(canvas: np.ndarray, shape: str, center: Tuple[int, int],
                radius: int, color: Tuple[int, int, int],
                texture: np.ndarray = None, angle: float = 0.0) -> None:
    import cv2
    mask = np.zeros(canvas.shape[:2], np.uint8)
    cx, cy = center
    if shape == "square":
        cv2.rectangle(mask, (cx - radius, cy - radius),
                      (cx + radius, cy + radius), 255, -1)
    elif shape == "ellipse":
        cv2.ellipse(mask, (cx, cy), (radius, int(radius * 0.62)), 0, 0, 360,
                    255, -1)
    else:  # heart: two circles + a triangle
        r = max(int(radius * 0.55), 2)
        off = int(radius * 0.45)
        top = cy - int(radius * 0.25)
        cv2.circle(mask, (cx - off, top), r, 255, -1)
        cv2.circle(mask, (cx + off, top), r, 255, -1)
        pts = np.array([[cx - radius, top + int(r * 0.4)],
                        [cx + radius, top + int(r * 0.4)],
                        [cx, cy + radius]], np.int32)
        cv2.fillPoly(mask, [pts], 255)
    if angle:
        # dsprites varies orientation over the full circle
        # (cdSprites.py latent_spec 'orientation': range(45))
        rot = cv2.getRotationMatrix2D((float(cx), float(cy)), float(angle), 1.0)
        mask = cv2.warpAffine(mask, rot, (mask.shape[1], mask.shape[0]))
    fill = np.empty_like(canvas)
    fill[:] = color
    if texture is not None:
        fill = (fill.astype(np.float32) * (texture[..., None] / 255.0)
                ).astype(np.uint8)
    canvas[mask > 0] = fill[mask > 0]


# Per-level factor specs — key order and values mirror the reference's
# config_levelN.json product order (cdSprites.py extract_label_groups:
# scale x colors x shapes [x position] [x background]), with per-combination
# sample counts from each JSON's samples_num (total = 30,000 per level).
LEVEL_SPECS = {
    1: {"scale": ["big"], "colors": ["white"],
        "shapes": ["square", "ellipse", "heart"],
        "position": [None], "background": [None], "per_combo": 10000},
    2: {"scale": ["big", "small"], "colors": ["white"],
        "shapes": ["square", "ellipse", "heart"],
        "position": [None], "background": [None], "per_combo": 5000},
    3: {"scale": ["small", "big"],
        "colors": ["red", "green", "yellow", "blue", "pink"],
        "shapes": ["square", "ellipse", "heart"],
        "position": [None], "background": [None], "per_combo": 1000},
    4: {"scale": ["small", "big"],
        "colors": ["yellow", "green", "blue", "red", "pink"],
        "shapes": ["heart", "ellipse", "square"],
        "position": list(POSITIONS), "background": [None], "per_combo": 250},
    5: {"scale": ["big", "small"],
        "colors": ["red", "green", "yellow", "pink", "blue"],
        "shapes": ["square", "ellipse", "heart"],
        "position": list(POSITIONS), "background": list(BACKGROUNDS),
        "per_combo": 125},
}


def render_sample(rng, level: int, size_name: str, color_name: str,
                  shape: str, pos_name, bg_name,
                  size: int = 64) -> Tuple[np.ndarray, str]:
    """Render one image for an explicit factor combination and build its
    caption in the reference's word order (folder-name order,
    cdSprites.py:270-278)."""
    if pos_name is None:
        # levels 1-3: dsprites position is free over the full grid
        # (latent_spec x/y in [5..29] of 32 -> ~pixels 10..58)
        center = (int(rng.integers(12, 53)), int(rng.integers(12, 53)))
    else:
        base = POSITIONS[pos_name]
        center = (base[0] + int(rng.integers(-3, 4)),
                  base[1] + int(rng.integers(-3, 4)))
    if bg_name is None:
        canvas = np.zeros((size, size, 3), np.uint8)
    else:
        canvas = np.repeat(_noise_texture(
            rng, BACKGROUNDS[bg_name])[..., None], 3, -1)
    texture = _noise_texture(rng, 170, amp=70) if level >= 3 else None
    angle = float(rng.uniform(0, 360))
    _draw_shape(canvas, shape, center, SIZES[size_name],
                COLORS[color_name], texture, angle=angle)

    caption = shape
    if level >= 2:
        caption = f"{size_name} {shape}"
    if level >= 3:
        caption = f"{size_name} {color_name} {shape}"
    if level >= 4:
        caption = f"{caption} {pos_name}"
    if level >= 5:
        caption = f"{caption} {bg_name}"
    return canvas, caption


def make_sample(rng, level: int, size: int = 64) -> Tuple[np.ndarray, str]:
    """One i.i.d. sample (kept for fixtures/tests); training-set generation
    uses the reference's balanced product enumeration in generate_level."""
    spec = LEVEL_SPECS[level]
    return render_sample(
        rng, level,
        spec["scale"][rng.integers(len(spec["scale"]))],
        spec["colors"][rng.integers(len(spec["colors"]))],
        spec["shapes"][rng.integers(len(spec["shapes"]))],
        spec["position"][rng.integers(len(spec["position"]))],
        spec["background"][rng.integers(len(spec["background"]))],
        size=size)


def generate_level(level: int, count: int, out_dir: str, seed: int = 0,
                   test_fraction: float = 0.1, fmt: str = "h5") -> str:
    """Write level directory with traindata.h5 (+ testdata.h5); with
    ``fmt="pkl"`` the same arrays go to traindata.pkl / testdata.pkl as a
    pickled ``{"image", "text"}`` dict, which needs no h5py.

    Sampling structure mirrors the reference generator: enumerate the
    cartesian product of the level's factors in the JSON-spec order and
    emit an equal number of samples per combination
    (cdSprites.py extract_label_groups + samples_num), scaled so the total
    matches ``count``.  Pass count=30000 for the reference's exact totals.
    """
    import itertools

    if fmt not in ("h5", "pkl"):
        raise ValueError(f"fmt must be 'h5' or 'pkl', got {fmt!r}")
    rng = np.random.default_rng(seed + level)
    level_dir = os.path.join(out_dir, f"level{level}")
    os.makedirs(level_dir, exist_ok=True)
    spec = LEVEL_SPECS[level]
    combos = list(itertools.product(spec["scale"], spec["colors"],
                                    spec["shapes"], spec["position"],
                                    spec["background"]))
    for split, n in (("traindata", count),
                     ("testdata", max(int(count * test_fraction), 1))):
        per_combo = max(n // len(combos), 1)
        n_total = per_combo * len(combos)
        imgs = np.zeros((n_total, 64, 64, 3), np.uint8)
        caps: List[bytes] = []
        i = 0
        for size_name, color_name, shape, pos_name, bg_name in combos:
            for _ in range(per_combo):
                img, cap = render_sample(rng, level, size_name, color_name,
                                         shape, pos_name, bg_name)
                imgs[i] = img
                caps.append(cap.encode("utf8"))
                i += 1
        path = os.path.join(level_dir, f"{split}.{fmt}")
        if fmt == "pkl":
            with open(path, "wb") as f:
                pickle.dump({"image": imgs, "text": np.array(caps)}, f)
        else:
            import h5py
            with h5py.File(path, "w") as f:
                f.create_dataset("image", data=imgs)
                f.create_dataset("text", data=np.array(caps))
    return level_dir


def main():
    parser = argparse.ArgumentParser(description="Generate CdSprites+ levels")
    parser.add_argument("--level", default=0, type=int,
                        help="single level to generate (0 = all five)")
    parser.add_argument("--count", default=10000, type=int,
                        help="training samples per level")
    parser.add_argument("--out_dir", default="./data/CdSpritesplus")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--format", default="h5", choices=("h5", "pkl"),
                        help="pkl writes the same arrays without h5py")
    args = parser.parse_args()
    levels = [args.level] if args.level else [1, 2, 3, 4, 5]
    for lvl in levels:
        d = generate_level(lvl, args.count, args.out_dir, args.seed,
                           fmt=args.format)
        print(f"level {lvl}: {args.count} samples -> {d}")


if __name__ == "__main__":
    main()
