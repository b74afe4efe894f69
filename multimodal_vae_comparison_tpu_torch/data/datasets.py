"""Dataset classes (counterpart of ``data/datasets.py``).

Host-side numpy, as in the JAX package: one instance per modality, the same
``feature_dims`` contract and file formats (h5 / pkl / npy / pt / image
dirs), data as float32 with masks as a separate boolean array, everything
preprocessed once into contiguous arrays.  ``h5py`` and ``cv2`` are imported
where a file of theirs is read.

Every dataset of the JAX package is ported: CdSprites+, MNIST-SVHN,
SPRITES, CUB, CelebA, FashionMNIST, PolyMNIST, VILANRO and the in-memory
synthetic set.
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


class FASHIONMNIST(BaseDataset):
    """FashionMNIST image and label (reference datasets.py:749-810), read
    offline from ``fashionmnist.npz`` (keys ``data`` (N, 28, 28) and
    ``labels`` (N,)) at ``path``, a file or the directory that holds it;
    the label modality is the 10-class one-hot."""

    feature_dims = {"image": [28, 28, 1], "label": [10]}
    text2img_size = (28, 64, 3)

    def __init__(self, pth, testpth, mod_type):
        super().__init__(pth, testpth, mod_type)
        self.labels_train = None

    def labels(self):
        # the integer labels of the last file read
        return self.labels_train

    def eval_statistics_fn(self):
        from multimodal_vae_comparison_tpu_torch.eval.eval_fashionmnist import (
            fashionmnist_eval)
        return fashionmnist_eval

    def _npz(self):
        path = self.current_path
        if os.path.isdir(path):
            path = os.path.join(path, "fashionmnist.npz")
        d = np.load(path)
        self.labels_train = [int(x) for x in d["labels"]]
        return d["data"], d["labels"]

    def _mod_specific_loaders(self):
        return {"image": self._load_image, "label": self._load_label}

    def _mod_specific_savers(self):
        return {"image": self._decode_image,
                "label": lambda d, m=None: [str(i) for i in np.argmax(d, -1)]}

    def _load_image(self):
        data, _ = self._npz()
        d = data.reshape(-1, 28, 28, 1).astype(np.float32)
        return d / max(d.max(), 1.0), None

    def _load_label(self):
        self.categorical = True
        _, labels = self._npz()
        onehot = np.zeros((len(labels), 10), dtype=np.float32)
        onehot[np.arange(len(labels)), labels] = 1
        return onehot, None


class MNIST_SVHN(BaseDataset):
    """MNIST-SVHN pairs by index files (reference datasets.py:416-495).

    ``path`` / ``test_datapath`` name a split's index file (``.npy``, or
    ``.pt`` as ``torch.save`` wrote it); the digit arrays are read from
    ``mnist.npz`` / ``svhn.npz`` (keys 'data', 'labels') beside it, the
    ``data_proc/mnistsvhn.py`` contract.  Every 7th pair is kept, from the
    second, up to 200,000, as the reference subsamples; each image is
    divided by the largest value of its split."""

    feature_dims = {"mnist": [28, 28, 1], "svhn": [32, 32, 3]}
    text2img_size = (32, 32, 3)

    def __init__(self, pth, testpth, mod_type):
        super().__init__(pth, testpth, mod_type)
        self.train_labels = None

    def labels(self):
        # the digit labels of the last split read
        return self.train_labels

    def eval_statistics_fn(self):
        from multimodal_vae_comparison_tpu_torch.eval.eval_mnistsvhn import mnistsvhn_eval
        return mnistsvhn_eval

    def _mod_specific_loaders(self):
        return {"mnist": self._load_mnist, "svhn": self._load_svhn}

    def _mod_specific_savers(self):
        return {"mnist": self._decode_image, "svhn": self._decode_image}

    def _raw_arrays(self, name):
        npz = os.path.join(os.path.dirname(self.current_path), f"{name}.npz")
        if not os.path.exists(npz):
            raise FileNotFoundError(f"expected {npz} with keys 'data', 'labels' beside "
                                    "the index file")
        with np.load(npz) as d:
            return d["data"], d["labels"]

    def _indices(self):
        return np.asarray(load_data(self.current_path))[1::7][:200000]

    def _load_mnist(self):
        data, labels = self._raw_arrays("mnist")
        idx = self._indices()
        self.train_labels = labels[idx]
        d = data[idx].reshape(-1, 28, 28, 1).astype(np.float32)
        return d / d.max(), None

    def _load_svhn(self):
        data, labels = self._raw_arrays("svhn")
        idx = self._indices()
        self.train_labels = labels[idx]
        d = data[idx].astype(np.float32)
        if d.shape[1] == 3:           # CHW -> HWC
            d = d.transpose(0, 2, 3, 1)
        return d / d.max(), None


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


class POLYMNIST(BaseDataset):
    """PolyMNIST: 5 image modalities m0..m4 (reference datasets.py:812-881)
    from ``.npy`` (or ``torch.save``'d ``.pt``) arrays of (N, 28, 28, 3).
    The digit labels are read from ``labels.npy`` / ``test_labels.npy``
    beside the arrays (the ``data_proc/polymnist.py`` contract; a file
    named ``test_*`` takes the test labels), when there."""

    feature_dims = {f"m{i}": [28, 28, 3] for i in range(5)}
    text2img_size = (28, 28, 3)

    def __init__(self, pth, testpth, mod_type):
        super().__init__(pth, testpth, mod_type)
        self._labels = None

    def labels(self):
        return self._labels

    def eval_statistics_fn(self):
        from multimodal_vae_comparison_tpu_torch.eval.eval_polymnist import polymnist_eval
        return polymnist_eval

    def _mod_specific_loaders(self):
        return {k: self._load_image for k in self.feature_dims}

    def _mod_specific_savers(self):
        return {k: self._decode_image for k in self.feature_dims}

    def _load_image(self):
        d = np.asarray(self.get_data_raw()).astype(np.float32)
        d = d.reshape(-1, *self.feature_dims[self.mod_type])
        if d.max() > 1.5:
            d = d / 255.0
        base = os.path.basename(str(self.current_path))
        lab = os.path.join(os.path.dirname(str(self.current_path)),
                           "test_labels.npy" if base.startswith("test_") else "labels.npy")
        if os.path.exists(lab):
            self._labels = np.load(lab)
        return d, None


class VILANRO(BaseDataset):
    """VILANRO trimodal robotics dataset (reference datasets.py:884-1125):
    front RGB images, word-level language one-hots, padded action
    trajectories, plus the auxiliary shapes / colors / objects modalities,
    from the pkl layout of ``lanro/collect.py`` (``vocab.txt`` beside the
    files).  Actions come as padded floats (``actions``), as 41-bin
    quantile tokens (``action_tokens``) or as start-relative waypoints
    padded by their last step (``action_waypoints``)."""

    feature_dims = {"front RGB": [64, 64, 3], "objects": [1, 3],
                    "actions": [100, 4, 1], "language": [4, 9, 1],
                    "shapes": [2, 6], "colors": [2, 6],
                    "action_tokens": [100, 4, 41],
                    "action_waypoints": [100, 4, 1]}
    text2img_size = (64, 250, 3)
    # discretized-action-token vocabulary size (per action dimension)
    ACTION_BINS = 41

    def __init__(self, pth, testpth, mod_type):
        super().__init__(pth, testpth, mod_type)
        self.vocab = self._load_vocab("vocab.txt")
        self.feature_dims = dict(self.feature_dims)
        self.feature_dims["language"] = [4, len(self.vocab), 1]
        try:
            self.vocab_atts = self._load_vocab("vocab_atts.txt")
        except FileNotFoundError:
            self.vocab_atts = []
        self.lang_labels = None

    def get_forbidden_subsets(self):
        if "stage2" in (self.path or "") or "stage3" in (self.path or ""):
            return ["front RGB+objects+language"]
        return []

    def _load_vocab(self, fname):
        path = os.path.join(os.path.dirname(self.path or "."), fname)
        if not os.path.exists(path):
            raise FileNotFoundError(f"Path to {fname} not found at {path}")
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]

    def _mod_specific_loaders(self):
        return {"front RGB": self._load_rgb, "actions": self._load_actions,
                "language": self._load_lang, "objects": self._load_atts,
                "shapes": self._load_atts, "colors": self._load_atts,
                "action_tokens": self._load_action_tokens,
                "action_waypoints": self._load_waypoints}

    def _mod_specific_savers(self):
        return {"front RGB": self._decode_image,
                "actions": lambda d, m=None: d,
                "objects": lambda d, m=None: d,
                "language": self._decode_lang,
                "shapes": self._decode_atts, "colors": self._decode_atts,
                "action_tokens": self._decode_action_tokens,
                "action_waypoints": lambda d, m=None: d}

    def _load_rgb(self):
        """Frames in [0, 1]; the camera's size is read from them (the
        collector renders 64 px, or larger with ``--size``)."""
        d = np.asarray(self.get_data_raw()).astype(np.float32)
        if d.ndim == 4:
            s = d.shape[1]
        else:
            s = int(round((d.size / len(d) / 3) ** 0.5))
        d = d.reshape(-1, s, s, 3)
        self.feature_dims["front RGB"] = [s, s, 3]
        if d.max() > 1.5:
            d = d / 255.0
        return d, None

    def _load_lang(self):
        """Word one-hots and masks.  The sequence length is fitted on the
        train file and then frozen, so that a test split is cut or padded
        to the encoder's length (measured from the train file when the test
        split loads first)."""
        self.has_masks = True
        self.categorical = True
        data = self.get_data_raw()
        self.lang_labels = list(data)
        seqs = [[self.vocab.index(w) for w in str(x).split(" ") if w] for x in data]
        if self.current_path == self.path:
            self._lang_max_len = max(len(s) for s in seqs)
        elif getattr(self, "_lang_max_len", None) is None:
            train_raw = load_data(self.path)
            self._lang_max_len = max(
                len([w for w in str(x).split(" ") if w]) for x in train_raw)
        max_len = self._lang_max_len
        self.feature_dims["language"][0] = max_len
        idx = np.zeros((len(seqs), max_len), dtype=np.int64)
        for i, s in enumerate(seqs):
            s = s[:max_len]
            idx[i, :len(s)] = s
        onehot = np.eye(len(self.vocab), dtype=np.float32)[idx]
        masks = text_utils.lengths_to_mask(
            [min(len(s), max_len) for s in seqs], max_len)
        return onehot, masks

    def _load_actions(self):
        """Trajectories zero-padded to 100 steps, masks on the real ones."""
        self.has_masks = True
        data = [np.asarray(x, dtype=np.float32) for x in self.get_data_raw()]
        max_len = self.feature_dims["actions"][0]
        dim = data[0].shape[-1]
        out = np.zeros((len(data), max_len, dim), dtype=np.float32)
        lens = []
        for i, seq in enumerate(data):
            n = min(len(seq), max_len)
            out[i, :n] = seq[:n]
            lens.append(n)
        return out, text_utils.lengths_to_mask(lens, max_len)

    def _load_atts(self):
        self.categorical = True
        data = self.get_data_raw()
        return np.stack([text_utils.one_hot_encode_words(self.vocab_atts, f)
                         for f in data]).astype(np.float32), None

    def _load_waypoints(self):
        """Start-relative achieved end-effector positions (``collect.py
        --waypoints``): the "actions" layout, but padded by repeating the
        last position, with full masks, so every tail step is a supervised
        endpoint prediction."""
        data, masks = self._load_actions()
        lens = masks.sum(axis=1).astype(int)
        for i, n in enumerate(lens):
            if 0 < n < data.shape[1]:
                data[i, n:] = data[i, n - 1]
        return data, np.ones_like(masks)

    def _fit_action_codebook(self, cont, masks, K):
        valid = cont[masks]                              # (M, A) real steps
        qs = np.linspace(0.0, 1.0, K + 1)
        self._action_edges = np.quantile(valid, qs, axis=0)     # (K+1, A)
        # bin centres decode tokens; the interior edges bin actions
        self.action_bin_centers = (
            0.5 * (self._action_edges[:-1] + self._action_edges[1:])
        ).astype(np.float32)                             # (K, A)

    def _load_action_tokens(self):
        """Each action dimension binned into ``ACTION_BINS`` bins at its
        quantiles over the real steps and one-hot encoded: (N, T, A) floats
        become (N, T, A, K) tokens, trained with ``category_ce``.  The
        codebook is fitted on the train file and then frozen (fitted from
        the train file when the test split loads first), so that test
        targets and decoded tokens use the model's own codebook."""
        self.categorical = True
        cont, masks = self._load_actions()               # (N, T, A), (N, T)
        K = self.ACTION_BINS
        A = cont.shape[-1]
        if self.current_path == self.path:
            self._fit_action_codebook(cont, masks, K)
        elif getattr(self, "_action_edges", None) is None:
            saved = self.current_path
            self.current_path = self.path
            try:
                train_cont, train_masks = self._load_actions()
            finally:
                self.current_path = saved
            self._fit_action_codebook(train_cont, train_masks, K)
        edges = self._action_edges
        idx = np.stack([np.digitize(cont[..., a], edges[1:-1, a])
                        for a in range(A)], axis=-1)     # (N, T, A) in [0, K)
        self.feature_dims["action_tokens"] = [cont.shape[1], A, K]
        return np.eye(K, dtype=np.float32)[idx], masks

    def _decode_action_tokens(self, data, masks=None):
        """(..., T, A, K) token scores -> continuous (..., T, A) actions: each
        dimension's argmax bin centre (the inverse of the tokens' load)."""
        idx = np.asarray(data).argmax(-1)                # (..., T, A)
        centers = self.action_bin_centers                # (K, A)
        out = np.stack([centers[idx[..., a], a]
                        for a in range(idx.shape[-1])], axis=-1)
        if masks is not None:
            out = out * np.asarray(masks, out.dtype)[..., None]
        return out

    def _decode_lang(self, data, masks=None):
        idx = np.asarray(data).argmax(-1)
        out = []
        for i, row in enumerate(idx):
            words = [self.vocab[int(j)] for j in np.atleast_1d(row)]
            if masks is not None:
                words = words[: int(np.asarray(masks[i]).sum())]
            out.append(" ".join(words).replace("none", "").strip())
        return out

    def _decode_atts(self, data, masks=None):
        idx = np.asarray(data).argmax(-1)
        return [" ".join(self.vocab_atts[int(j)] for j in np.atleast_1d(row))
                for row in idx]

    def labels(self):
        if self.mod_type != "language":
            return None
        return self.lang_labels


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


DATASETS = {"cdspritesplus": CDSPRITESPLUS, "mnist_svhn": MNIST_SVHN, "sprites": SPRITES,
            "cub": CUB, "celeba": CELEBA, "fashionmnist": FASHIONMNIST,
            "polymnist": POLYMNIST, "vilanro": VILANRO, "synthetic": SYNTHETIC}


def get_dataset_class(name: str):
    key = (name or "").lower()
    if key not in DATASETS:
        raise KeyError(f"Did not find dataset with name {name}; "
                       f"available: {sorted(DATASETS)}")
    return DATASETS[key]
