"""Batched inference engine (counterpart of ``serving/engine.py``).

* pads each request chunk up to the next bucket size by repeating its last
  row, and chunks requests larger than the largest bucket;
* runs ``POE.forward`` under ``torch.inference_mode()`` on the engine's
  device (CUDA unless the caller passes ``device="cpu"``);
* returns host numpy (images NHWC), trimmed to the true request size.

The first call per (present-set, bucket) runs under a lock, as the
reference serialises its first compile per shape: here that first call is
where the CUDA kernels are built and loaded.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_vae_comparison_tpu_torch.device import resolve_device

DEFAULT_BUCKETS = (1, 8, 32, 128)


@dataclasses.dataclass(frozen=True)
class ModelHandle:
    """The minimal handle the engine and server take: a model and its
    modality names."""

    model: torch.nn.Module

    @property
    def mod_names(self) -> Tuple[str, ...]:
        return self.model.mod_names


class InferenceEngine:
    def __init__(self, infer, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 device: Optional[Union[str, torch.device]] = None):
        """:param infer: a handle with ``.model`` and ``.mod_names``; the
            model is moved to ``device`` and put in eval mode"""
        self.device = resolve_device(device)
        self.exp = infer
        self.model = infer.model.to(self.device).eval()
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._warm: set = set()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _tensor(self, arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, dtype)

    def _run(self, batch, present: Tuple[str, ...], seed: int):
        generator = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            out = self.model.forward(batch, present, generator=generator)
            return {name: mo.decoder_dist.mean[0].cpu().numpy()
                    for name, mo in out.mods.items()
                    if mo.decoder_dist is not None}

    # -- public API ------------------------------------------------------------------

    def generate(self, inputs: Dict[str, Dict[str, np.ndarray]],
                 seed: int = 0) -> Dict[str, np.ndarray]:
        """Cross-/self-generate all modalities from the given inputs.

        :param inputs: {"mod_i": {"data": (N, ...), "masks": optional}}
        :return: {"mod_j": (N, ...)} reconstructions for every modality
        """
        if not inputs:
            raise ValueError("generate() needs at least one input modality")
        unknown = sorted(set(inputs) - set(self.exp.mod_names))
        if unknown:
            raise KeyError(
                f"unknown modalities {unknown}; model has {list(self.exp.mod_names)}")
        present = tuple(sorted(inputs.keys()))
        sizes = {name: len(mod["data"]) for name, mod in inputs.items()}
        if len(set(sizes.values())) > 1:
            raise ValueError(f"input modalities disagree on batch size: {sizes}")
        n = len(next(iter(inputs.values()))["data"])
        outputs: Dict[str, list] = {}
        done = 0
        while done < n:
            take = min(n - done, self.buckets[-1])
            bucket = self._bucket(take)
            pad = bucket - take
            batch = {}
            for name in self.exp.mod_names:
                if name not in inputs:
                    batch[name] = {"data": None, "masks": None}
                    continue
                data = np.asarray(inputs[name]["data"][done:done + take])
                if pad:
                    data = np.concatenate([data, np.repeat(data[-1:], pad, 0)], 0)
                entry = {"data": self._tensor(data, torch.float32), "masks": None}
                masks = inputs[name].get("masks")
                if masks is not None:
                    m = np.asarray(masks[done:done + take])
                    if pad:
                        m = np.concatenate([m, np.repeat(m[-1:], pad, 0)], 0)
                    entry["masks"] = self._tensor(m, torch.bool)
                batch[name] = entry
            shape_key = (present, bucket)
            if shape_key in self._warm:
                out = self._run(batch, present, seed)
            else:
                with self._lock:  # serialize the first call per shape
                    out = self._run(batch, present, seed)
                    self._warm.add(shape_key)
            for name, arr in out.items():
                outputs.setdefault(name, []).append(arr[:take])
            done += take
        return {k: np.concatenate(v) for k, v in outputs.items()}

    def decode_latents(self, z: np.ndarray) -> Dict[str, np.ndarray]:
        """Decode given (N, n_latents) latent vectors with every decoder."""
        zt = self._tensor(np.asarray(z), torch.float32)[None]
        out = {}
        with torch.inference_mode():
            for name in self.exp.mod_names:
                out[name] = self.model.decode_mod(name, zt).mean[0].cpu().numpy()
        return out
