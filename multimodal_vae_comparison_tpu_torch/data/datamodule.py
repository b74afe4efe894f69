"""DataModule: multimodal loading, shared shuffle and split, static-shape
batches (counterpart of ``data/datamodule.py``).

The same rules as the JAX package, with numpy's RNG, so that from the same
config and files the split and every batch are bit-identical to it: one
dataset instance per modality, one permutation shared by all modalities, a
train/val split by ``test_split``; the trailing ragged batch is dropped in
training and padded in eval; labels follow the shuffle.  Batches are numpy
dicts ``{"mod_i": {"data", "masks"}}``; :func:`prefetch_to_device` moves them
to the card.
"""
from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from multimodal_vae_comparison_tpu_torch.data.datasets import get_dataset_class
from multimodal_vae_comparison_tpu_torch.device import resolve_device


class DataModule:
    def __init__(self, config):
        self.config = config
        self.batch_size = config.batch_size
        self.val_split = config.test_split
        self.dataset_name = config.dataset_name
        cls = get_dataset_class(self.dataset_name)
        self.datasets = [cls(m.path, m.test_datapath, m.mod_type) for m in config.mods]
        self.labels_train: Optional[List] = None
        self.labels_val: Optional[List] = None
        self._train: Optional[List[Dict[str, np.ndarray]]] = None
        self._val: Optional[List[Dict[str, np.ndarray]]] = None
        self._test: Optional[List[Dict[str, np.ndarray]]] = None
        self.labels_test: Optional[List] = None

    # -- setup -----------------------------------------------------------------

    def setup(self) -> None:
        """Load all modalities, apply one shared shuffle, split train/val
        (reference dataloader.py:49-68)."""
        if self._train is not None:
            return
        rng = np.random.default_rng(self.config.seed)
        shuffle = None
        train, val = [], []
        for dataset, mod in zip(self.datasets, self.config.mods):
            data, masks = dataset.get_data("train")
            if shuffle is None:
                shuffle = rng.permutation(len(data))
            elif len(data) != len(shuffle):
                # truncating a longer modality would train on misaligned pairs
                raise ValueError(
                    f"modality files disagree on sample count: "
                    f"{mod.name} has {len(data)} rows, "
                    f"{self.config.mods[0].name} has {len(shuffle)}")
            data = data[shuffle]
            masks = masks[shuffle] if masks is not None else None
            n_train = int(len(data) * (1 - self.val_split))
            train.append({"data": data[:n_train],
                          "masks": masks[:n_train] if masks is not None else None})
            val.append({"data": data[n_train:],
                        "masks": masks[n_train:] if masks is not None else None})
            # feature dims flow into the model specs from the actual arrays
            mod.feature_dims = list(data.shape[1:])
        labels = self.get_labels()
        if labels is not None:
            labels = [labels[j] for j in shuffle]
            n_train = int(len(labels) * (1 - self.val_split))
            self.labels_train = labels[:n_train]
            self.labels_val = labels[n_train:]
        self._train, self._val = train, val
        # dedicated test split from test_datapath when configured; the val
        # split stands in otherwise (reference dataloader.py:166-176)
        if any(m.test_datapath for m in self.config.mods):
            test = []
            for dataset in self.datasets:
                data, masks = dataset.get_data("test")
                test.append({"data": data, "masks": masks})
            self._test = test
            lab = None
            for d in self.datasets:
                lab = d.labels()
                if lab is not None:
                    break
            self.labels_test = lab

    def get_labels(self):
        if getattr(self.config, "labels", None):
            return self.config.labels
        for d in self.datasets:
            lab = d.labels()
            if lab is not None:
                return lab
        return None

    def split_arrays(self, i: int, split: str = "train"):
        """(data, masks) of modality ``i``'s train or val split, after the
        shared shuffle."""
        self.setup()
        part = {"train": self._train, "val": self._val}[split]
        return part[i]["data"], part[i]["masks"]

    @property
    def n_train(self) -> int:
        return len(self._train[0]["data"])

    @property
    def n_val(self) -> int:
        return len(self._val[0]["data"])

    def feature_dims(self) -> List[List[int]]:
        return [list(m.feature_dims) for m in self.config.mods]

    # -- batches -----------------------------------------------------------------

    def _make_batch(self, split: List[Dict], idx: np.ndarray) -> Dict:
        from multimodal_vae_comparison_tpu_torch.data import native
        batch = {}
        for i, mod in enumerate(split):
            masks = mod["masks"]
            batch[f"mod_{i + 1}"] = {
                "data": native.gather(mod["data"], idx),
                "masks": native.gather(masks, idx) if masks is not None else None,
            }
        return batch

    def batches(self, split: str = "train", batch_size: Optional[int] = None,
                shuffle: bool = False, seed: int = 0,
                drop_remainder: bool = True) -> Iterator[Dict]:
        """Iterate static-shape batches of one split."""
        self.setup()
        if split == "train":
            data = self._train
        elif split == "test":
            data = self._test if self._test is not None else self._val
        else:
            data = self._val
        n = len(data[0]["data"])
        bs = batch_size or self.batch_size
        order = np.arange(n)
        if shuffle:
            order = np.random.default_rng(seed).permutation(n)
        n_full = n // bs
        for b in range(n_full):
            yield self._make_batch(data, order[b * bs:(b + 1) * bs])
        rem = n - n_full * bs
        if rem and not drop_remainder:
            # pad the tail to keep shapes static (padded rows repeat data);
            # tile when the whole split is smaller than one pad's worth
            reps = int(np.ceil((bs - rem) / n))
            pad = np.tile(order, reps)[: bs - rem]
            yield self._make_batch(data, np.concatenate([order[n_full * bs:], pad]))

    def steps_per_epoch(self, split: str = "train") -> int:
        self.setup()
        n = self.n_train if split == "train" else self.n_val
        return max(n // self.batch_size, 1)


def _tensors(batch, convert):
    return {name: {k: None if v is None else convert(v) for k, v in mod.items()}
            for name, mod in batch.items()}


def prefetch_to_device(iterator: Iterator[Dict],
                       device: Optional[Union[str, torch.device]] = None,
                       size: int = 2) -> Iterator[Dict]:
    """Numpy batches -> tensor batches on ``device``, ``size`` batches ahead.

    On the card each array is copied into pinned host memory and sent with
    a ``non_blocking`` copy on a side stream, so the copy of batch n+1
    overlaps the step on batch n; before a batch is yielded the current
    stream waits on the event recorded after its copies, and its tensors
    are marked as used there.  On the CPU the arrays are wrapped as they are.
    """
    device = resolve_device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield _tensors(batch, torch.from_numpy)
        return
    stream = torch.cuda.Stream(device)
    queue = collections.deque()
    it = iter(iterator)

    def put(batch):
        with torch.cuda.stream(stream):
            moved = _tensors(batch, lambda a: torch.from_numpy(a).pin_memory().to(
                device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        return moved, event

    def enqueue(k):
        for _ in range(k):
            batch = next(it, None)
            if batch is None:
                return
            queue.append(put(batch))

    enqueue(max(size, 1))
    while queue:
        batch, event = queue.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for mod in batch.values():
            for t in mod.values():
                if t is not None:
                    t.record_stream(current)
        yield batch
        enqueue(1)
