"""SPRITES-style video dataset generator, fully offline (counterpart of
``data_proc/sprites_gen.py``).

A copy of the JAX package's generator (the port imports nothing of that
package): an articulated stick figure with 4 coloured attribute parts
(skin, pants, top, hair; 6 colours each) animated over 8 frames by one of
9 action/direction combinations (walk, spellcard, slash x front, left,
right).  From the same seed it writes the same shards as the JAX
generator, in the reference's layout:

``{action}_{direction}_frames_{split}.npy``      (N, 8, 64, 64, 3) float32
``{action}_{direction}_attributes_{split}.npy``  (N, 8, 4, 6) one-hot

with the test shards in ``out_dir/test`` (the configs' ``test_datapath``),
``per_combo`` train and ``per_combo // 5`` test clips per combination.
``cv2`` is imported where a sprite is drawn.

    python -m multimodal_vae_comparison_tpu_torch.data_proc.sprites_gen \
        --per_combo 64 --out_dir ./data/sprites
"""
from __future__ import annotations

import argparse
import os

import numpy as np

ACTIONS = ["walk", "spellcard", "slash"]
DIRECTIONS = ["front", "left", "right"]
ATTR_COLORS = np.array([
    [230, 180, 160], [230, 220, 80], [150, 150, 150],
    [200, 200, 220], [220, 200, 170], [140, 90, 50],
], np.float32) / 255.0   # 6 palette entries reused per attribute slot


def _draw_sprite(frame, cx, cy, colors, scale=1.0, lean=0.0):
    """Stick figure: pants, top (leaning), head (skin), hair."""
    import cv2
    s = scale
    lean_px = int(lean * 6)
    head_c = tuple(float(c) for c in colors[0])    # skin
    pants_c = tuple(float(c) for c in colors[1])
    top_c = tuple(float(c) for c in colors[2])
    hair_c = tuple(float(c) for c in colors[3])
    cv2.rectangle(frame, (int(cx - 6 * s), int(cy + 4 * s)),
                  (int(cx + 6 * s), int(cy + 16 * s)), pants_c, -1)
    pts = np.array([[cx - 7 * s + lean_px, cy - 8 * s],
                    [cx + 7 * s + lean_px, cy - 8 * s],
                    [cx + 6 * s, cy + 5 * s],
                    [cx - 6 * s, cy + 5 * s]], np.int32)
    cv2.fillPoly(frame, [pts], top_c)
    cv2.circle(frame, (int(cx + lean_px), int(cy - 13 * s)),
               max(int(5 * s), 2), head_c, -1)
    cv2.ellipse(frame, (int(cx + lean_px), int(cy - 16 * s)),
                (max(int(5 * s), 2), max(int(3 * s), 1)), 0, 180, 360,
                hair_c, -1)


def make_sequence(rng, action: str, direction: str, attrs: np.ndarray,
                  size=64, n_frames=8) -> np.ndarray:
    """One (n_frames, size, size, 3) clip of the sprite with palette
    indices ``attrs`` (skin, pants, top, hair) doing ``action`` facing
    ``direction``.  ``rng`` is kept for the JAX generator's signature; the
    motion is deterministic."""
    colors = [ATTR_COLORS[a] for a in attrs]
    frames = np.zeros((n_frames, size, size, 3), np.float32)
    base_x = {"front": 32, "left": 24, "right": 40}[direction]
    for t in range(n_frames):
        phase = t / n_frames * 2 * np.pi
        cx, cy, scale, lean = base_x, 34, 1.0, 0.0
        if action == "walk":
            step = {"front": 0, "left": -1, "right": 1}[direction]
            cx = base_x + step * t * 1.5 + 3 * np.sin(phase)
            cy = 34 + 2 * np.abs(np.sin(phase * 2))
        elif action == "spellcard":
            scale = 1.0 + 0.25 * np.sin(phase)
        else:  # slash
            lean = np.sin(phase)
        _draw_sprite(frames[t], cx, cy, colors, scale, lean)
    return frames


def generate(per_combo: int, out_dir: str, seed: int = 0,
             splits=("train", "test")) -> None:
    """Write the shards of ``splits`` under ``out_dir`` (test in
    ``out_dir/test``); attributes are drawn from ``np.random.default_rng(seed)``."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for split in splits:
        split_dir = out_dir if split == "train" else os.path.join(out_dir, "test")
        os.makedirs(split_dir, exist_ok=True)
        n = per_combo if split == "train" else max(per_combo // 5, 1)
        for action in ACTIONS:
            for direction in DIRECTIONS:
                frames = np.zeros((n, 8, 64, 64, 3), np.float32)
                attr_oh = np.zeros((n, 8, 4, 6), np.float32)
                for i in range(n):
                    attrs = rng.integers(0, 6, 4)
                    frames[i] = make_sequence(rng, action, direction, attrs)
                    attr_oh[i, :, np.arange(4), attrs] = 1.0
                np.save(os.path.join(
                    split_dir, f"{action}_{direction}_frames_{split}.npy"), frames)
                np.save(os.path.join(
                    split_dir, f"{action}_{direction}_attributes_{split}.npy"), attr_oh)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate the SPRITES shards")
    parser.add_argument("--per_combo", type=int, default=64,
                        help="sequences per action x direction combo")
    parser.add_argument("--out_dir", default="./data/sprites")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    generate(args.per_combo, args.out_dir, args.seed)
    print(f"SPRITES: {args.per_combo}x9 train sequences -> {args.out_dir}")


if __name__ == "__main__":
    main()
