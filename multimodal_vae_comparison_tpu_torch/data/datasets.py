"""Dataset classes (counterpart of ``data/datasets.py``).

Host-side numpy, as in the JAX package: one instance per modality, the same
``feature_dims`` contract and file formats (h5 / pkl / npy / pt / image
dirs), data as float32 with masks as a separate boolean array, everything
preprocessed once into contiguous arrays.  ``h5py`` and ``cv2`` are imported
where a file of theirs is read.

Only CdSprites+ is ported; the other datasets' names are known and raise,
naming the ROADMAP item that brings them.
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


DATASETS = {"cdspritesplus": CDSPRITESPLUS}
# known to the JAX package, not ported yet
_UNPORTED = ("cub", "mnist_svhn", "sprites", "celeba", "fashionmnist", "polymnist",
             "vilanro", "synthetic")


def get_dataset_class(name: str):
    key = (name or "").lower()
    if key in _UNPORTED:
        raise NotImplementedError(f"dataset '{name}' is not ported yet "
                                  "(ROADMAP Queue A item 7)")
    if key not in DATASETS:
        raise KeyError(f"Did not find dataset with name {name}; "
                       f"available: {sorted(DATASETS)}")
    return DATASETS[key]
