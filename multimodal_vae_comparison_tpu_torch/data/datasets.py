"""Dataset classes (counterpart of ``data/datasets.py``).

Host-side numpy, as in the JAX package: one instance per modality, the same
``feature_dims`` contract and file formats (h5 / pkl / npy / pt / image
dirs), data as float32 with masks as a separate boolean array, everything
preprocessed once into contiguous arrays.  ``h5py`` and ``cv2`` are imported
where a file of theirs is read.

CdSprites+, SPRITES, CUB, CelebA and the in-memory synthetic set are
ported; the other datasets' names are known and raise, naming the ROADMAP
item that brings them.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from multimodal_vae_comparison_tpu_torch.data import text as text_utils

_H5_CACHE: Dict[tuple, dict] = {}


def load_data(path: str):
    """Load raw data by suffix: .h5/.pkl/.pt/.pth/.npy or an image dir."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Path does not exist: {path}")
    if os.path.isdir(path):
        return load_images(path)
    suffix = os.path.splitext(path)[1]
    if suffix in (".pt", ".pth"):
        import torch
        return torch.load(path, map_location="cpu", weights_only=False)
    if suffix == ".pkl":
        with open(path, "rb") as f:
            return pickle.load(f)
    if suffix == ".h5":
        import h5py
        # read into memory and close the file, cached per (path, mtime): the
        # image and text modalities of one dataset read the same file
        key = (os.path.realpath(path), os.path.getmtime(path))
        if key not in _H5_CACHE:
            if len(_H5_CACHE) >= 4:   # bound resident copies
                _H5_CACHE.clear()
            with h5py.File(path, "r") as f:
                _H5_CACHE[key] = {k: np.asarray(f[k]) for k in f.keys()}
        return _H5_CACHE[key]
    if suffix == ".npy":
        return np.load(path)
    raise ValueError(f"Unrecognized dataset format: {path}")


def load_images(dirpath: str) -> np.ndarray:
    import cv2
    files = sorted(os.listdir(dirpath))
    imgs = [cv2.cvtColor(cv2.imread(os.path.join(dirpath, f)), cv2.COLOR_BGR2RGB)
            for f in files if f.lower().endswith((".png", ".jpg", ".jpeg"))]
    return np.stack(imgs)


class BaseDataset:
    """One instance per modality (reference datasets.py:14-200).

    Subclasses define ``feature_dims`` (mod_type -> dims) and mod-specific
    loaders and decoders in ``_mod_specific_loaders`` /
    ``_mod_specific_savers``.
    """

    feature_dims: Dict[str, List[int]] = {}
    text2img_size = (64, 192, 3)

    def __init__(self, pth: Optional[str], testpth: Optional[str], mod_type: str):
        if not self.feature_dims:
            raise TypeError(f"{type(self).__name__} must define feature_dims")
        self.path = pth
        self.testdata = testpth
        self.current_path = None
        self.mod_type = mod_type
        self.has_masks = False
        self.categorical = False

    # -- contracts -----------------------------------------------------------

    def _mod_specific_loaders(self) -> Dict[str, callable]:
        raise NotImplementedError

    def _mod_specific_savers(self) -> Dict[str, callable]:
        raise NotImplementedError

    def labels(self):
        return None

    def eval_statistics_fn(self):
        return None

    # -- loading ---------------------------------------------------------------

    def get_data_raw(self):
        return load_data(self.current_path)

    def get_data(self, split: str = "train") -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Returns (data, masks); masks is None for fixed-size modalities."""
        self.current_path = self.path if split == "train" else (self.testdata or self.path)
        loaders = self._mod_specific_loaders()
        if self.mod_type not in loaders:
            raise KeyError(f"Unsupported modality type {self.mod_type} for "
                           f"{type(self).__name__}")
        out = loaders[self.mod_type]()
        if isinstance(out, tuple):
            return out
        return np.asarray(out, dtype=np.float32), None

    # -- decoding helpers --------------------------------------------------------

    def decode_output(self, data, masks=None):
        savers = self._mod_specific_savers()
        return savers[self.mod_type](np.asarray(data), masks)

    def _decode_image(self, data, masks=None):
        return (np.clip(np.asarray(data), 0, 1) * 255).astype(np.uint8)

    def _decode_text(self, data, masks=None):
        return text_utils.onehot2text(data, masks)

    def _load_text_onehot(self, texts, seq_len) -> Tuple[np.ndarray, np.ndarray]:
        self.has_masks = True
        self.categorical = True
        from multimodal_vae_comparison_tpu_torch.data import native
        return native.one_hot_text(texts, seq_len)


class CDSPRITESPLUS(BaseDataset):
    """CdSprites+ h5 (keys 'image', 'text'; reference datasets.py:206-321)."""

    feature_dims = {"image": [64, 64, 3], "text": [45, 27, 1]}

    def __init__(self, pth, testpth, mod_type):
        super().__init__(pth, testpth, mod_type)
        width = 192
        if pth and "level1" in pth:
            width = 70
        elif pth and "level2" in pth:
            width = 120
        self.text2img_size = (64, width, 3)

    def level(self) -> int:
        for lvl in range(5, 0, -1):
            if f"level{lvl}" in (self.path or ""):
                return lvl
        return 1

    def labels(self):
        if self.current_path is None:
            self.current_path = self.path
        texts = [x.decode("utf8") for x in self.get_data_raw()["text"]]
        lvl = self.level()
        if lvl == 1:
            return texts
        out = []
        for x in texts:
            parts = x.split(" ")
            if lvl == 2:
                out.append(parts[:2])
            elif lvl == 3:
                out.append(parts[:3])
            elif lvl == 4:
                out.append(parts[:3] + [" ".join(parts[3:6])])
            else:
                out.append(parts[:3] + [" ".join(parts[3:6]), " ".join(parts[6:])])
        return out

    def eval_statistics_fn(self):
        from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import cdsprites_eval
        return cdsprites_eval

    def _mod_specific_loaders(self):
        return {"image": self._load_image, "text": self._load_text}

    def _mod_specific_savers(self):
        return {"image": self._decode_image, "text": self._decode_text}

    def _load_image(self):
        d = np.asarray(self.get_data_raw()["image"][:])
        d = d.reshape(-1, *self.feature_dims["image"])
        return d.astype(np.float32) / 255.0, None

    def _load_text(self):
        texts = [x.decode("utf8") for x in self.get_data_raw()["text"]]
        return self._load_text_onehot(texts, self.feature_dims["text"][0])


class CUB(BaseDataset):
    """Caltech-UCSD birds (reference datasets.py:323-414): 64x64 images from
    an ``.npy`` or an image directory, and character one-hot captions of 246
    characters from a ``.pkl`` list of strings (the JAX package's
    ``data_proc/surrogates.py`` contract, which the port's copy writes)."""

    feature_dims = {"image": [64, 64, 3], "text": [246, 27, 1]}
    text2img_size = (64, 380, 3)

    def eval_statistics_fn(self):
        from multimodal_vae_comparison_tpu_torch.eval.eval_cub import cub_eval
        return cub_eval

    def _mod_specific_loaders(self):
        return {"image": self._load_image, "text": self._load_text}

    def _mod_specific_savers(self):
        return {"image": self._decode_image, "text": self._decode_text}

    def _load_image(self):
        d = np.asarray(self.get_data_raw())
        d = d.reshape(-1, *self.feature_dims["image"]).astype(np.float32)
        if d.max() > 1.5:
            d = d / 255.0
        return d, None

    def _load_text(self):
        texts = [t.decode("utf8") if isinstance(t, bytes) else str(t)
                 for t in self.get_data_raw()]
        return self._load_text_onehot(texts, self.feature_dims["text"][0])


class CELEBA(BaseDataset):
    """CelebA images and 4 binary attributes as (4, 2) one-hots (reference
    datasets.py:650-747): ``.npy`` images and ``.npy`` attributes in {-1,
    1} (bald, eyeglasses, male, smiling)."""

    feature_dims = {"image": [64, 64, 3], "atts": [4, 2]}
    labelmap = [["hairy", "bald"], ["no eyeglasses", "eyeglasses"],
                ["female", "male"], ["not smiling", "smiling"]]

    def eval_statistics_fn(self):
        from multimodal_vae_comparison_tpu_torch.eval.eval_celeba import celeba_eval
        return celeba_eval

    def labels(self):
        # the decoded attribute strings of the last attributes loaded
        return getattr(self, "_labels", None)

    def _mod_specific_loaders(self):
        return {"image": self._load_image, "atts": self._load_atts}

    def _mod_specific_savers(self):
        return {"image": self._decode_image, "atts": self._decode_atts}

    def _load_image(self):
        d = np.asarray(self.get_data_raw()).astype(np.float32)
        d = d.reshape(-1, *self.feature_dims["image"])
        if d.max() > 1.5:
            d = d / 255.0
        return d, None

    def _load_atts(self):
        """One-hot (N, 4, 2): slot 0 set where the attribute is present."""
        self.categorical = True
        raw = (np.asarray(self.get_data_raw()).astype(np.float32) + 1) / 2
        onehot = np.zeros(raw.shape + (2,), dtype=np.float32)
        onehot[..., 1] = raw == 0
        onehot[..., 0] = raw == 1
        self._labels = self._decode_atts(onehot)
        return onehot, None

    def _decode_atts(self, data, masks=None):
        idx = np.asarray(data).argmax(-1)
        return [", ".join(self.labelmap[i][int(v)] for i, v in enumerate(row))
                for row in 1 - idx]   # slot 0 (present) -> labelmap[i][1]


class SPRITES(BaseDataset):
    """Trimodal animated-sprites video dataset (reference datasets.py:497-648):
    frames (8, 64, 64, 3), attributes (4, 6) and actions (9) from the
    per-action, per-direction ``.npy`` shards of ``data_proc/sprites_gen.py``
    in the directory ``path`` (train) or ``test_datapath`` (test)."""

    feature_dims = {"frames": [8, 64, 64, 3], "attributes": [4, 6], "actions": [9]}
    text2img_size = (64, 145, 3)
    directions = ["front", "left", "right"]
    actions_list = ["walk", "spellcard", "slash"]
    label_map = ["walk front", "walk left", "walk right", "spellcard front",
                 "spellcard left", "spellcard right", "slash front",
                 "slash left", "slash right"]
    attr_map = ["skin", "pants", "top", "hair"]
    att_names = [["pink", "yellow", "grey", "silver", "beige", "brown"],
                 ["white", "gold", "red", "armor", "blue", "green"],
                 ["maroon", "blue", "white", "armor", "brown", "shirt"],
                 ["green", "blue", "yellow", "silver", "red", "purple"]]

    def eval_statistics_fn(self):
        from multimodal_vae_comparison_tpu_torch.eval.eval_sprites import sprites_eval
        return sprites_eval

    def _split_tag(self):
        return "test" if self.current_path == self.testdata and self.testdata else "train"

    def _shards(self, kind):
        """The 9 shards of ``kind`` (frames or attributes) of the current
        split, in label order (action-major)."""
        return [np.load(os.path.join(self.current_path,
                                     f"{act}_{d}_{kind}_{self._split_tag()}.npy"))
                for act in self.actions_list for d in self.directions]

    def labels(self):
        acts, _ = self._load_actions()
        return [self.label_map[int(i)] for i in np.argmax(acts[:, :9], -1)]

    def _mod_specific_loaders(self):
        return {"frames": self._load_frames, "attributes": self._load_attributes,
                "actions": self._load_actions}

    def _mod_specific_savers(self):
        return {"frames": self._decode_image,
                "attributes": lambda d, m=None: d,
                "actions": lambda d, m=None: d}

    def _load_frames(self):
        return np.concatenate(self._shards("frames"), 0).astype(np.float32), None

    def _load_attributes(self):
        """Frame 0 of the (N, 8, 4, 6) one-hots: the attributes are static."""
        self.categorical = True
        shards = [a[:, 0, :, :] for a in self._shards("attributes")]
        return np.concatenate(shards, 0).astype(np.float32), None

    def _load_actions(self):
        """A 9-way one-hot of each clip's shard, ``3 * action + direction``."""
        self.categorical = True
        out = []
        for ai, act in enumerate(self.actions_list):
            for di, d in enumerate(self.directions):
                a = np.load(os.path.join(self.current_path,
                                         f"{act}_{d}_attributes_{self._split_tag()}.npy"))
                one_hot = np.zeros((a.shape[0], 9), dtype=np.float32)
                one_hot[:, 3 * ai + di] = 1
                out.append(one_hot)
        return np.concatenate(out, 0), None


class SYNTHETIC(BaseDataset):
    """In-memory synthetic bimodal dataset (a coloured square or circle and
    its caption, a miniature CdSprites+) for tests and runs without
    downloads.  ``path`` given as digits ("512") is the row count; the loaders
    read no file, so the same rows serve every split."""

    feature_dims = {"image": [64, 64, 3], "text": [45, 27, 1]}
    COLORS = {"red": (1.0, 0.1, 0.1), "green": (0.1, 1.0, 0.1),
              "blue": (0.2, 0.2, 1.0), "yellow": (1.0, 1.0, 0.1)}
    SHAPES = ["square", "circle"]

    def __init__(self, pth=None, testpth=None, mod_type="image", n: int = 256,
                 seed: int = 0):
        super().__init__(pth, testpth, mod_type)
        self.n = int(pth) if pth and str(pth).isdigit() else n
        self.seed = seed
        self._cache = None

    def _generate(self):
        if self._cache is not None:
            return self._cache
        rng = np.random.default_rng(self.seed)
        imgs = np.zeros((self.n, 64, 64, 3), dtype=np.float32)
        caps = []
        color_names = list(self.COLORS)
        for i in range(self.n):
            color = color_names[rng.integers(len(color_names))]
            shape = self.SHAPES[rng.integers(len(self.SHAPES))]
            cx, cy = rng.integers(16, 48, size=2)
            r = int(rng.integers(6, 14))
            c = np.array(self.COLORS[color], np.float32)
            if shape == "square":
                imgs[i, cy - r:cy + r, cx - r:cx + r] = c
            else:
                yy, xx = np.mgrid[:64, :64]
                imgs[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = c
            caps.append(f"{color} {shape}")
        self._cache = (imgs, caps)
        return self._cache

    def labels(self):
        return self._generate()[1]

    def _mod_specific_loaders(self):
        return {"image": self._load_image, "text": self._load_text}

    def _mod_specific_savers(self):
        return {"image": self._decode_image, "text": self._decode_text}

    def _load_image(self):
        return self._generate()[0], None

    def _load_text(self):
        return self._load_text_onehot(self._generate()[1], self.feature_dims["text"][0])


DATASETS = {"cdspritesplus": CDSPRITESPLUS, "sprites": SPRITES, "cub": CUB,
            "celeba": CELEBA, "synthetic": SYNTHETIC}
# known to the JAX package, not ported yet: the ROADMAP Queue A item of each
_UNPORTED = {"vilanro": "7b", "mnist_svhn": "7d", "fashionmnist": "7d", "polymnist": "7d"}


def get_dataset_class(name: str):
    key = (name or "").lower()
    if key in _UNPORTED:
        raise NotImplementedError(f"dataset '{name}' is not ported yet "
                                  f"(ROADMAP Queue A item {_UNPORTED[key]})")
    if key not in DATASETS:
        raise KeyError(f"Did not find dataset with name {name}; "
                       f"available: {sorted(DATASETS)}")
    return DATASETS[key]
