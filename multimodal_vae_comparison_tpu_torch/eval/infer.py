"""Restore a trained run for inference (counterpart of ``eval/infer.py``).

``MultimodalVAEInfer(path)`` finds the run directory's ``config.yml`` (at
``path`` or up to three levels above it), rebuilds the DataModule (whose
arrays give the modalities' feature dims) and the model, and loads the
port's own checkpoint, ``model/last/state.pt`` or ``model/best/state.pt``.
It serves ``InferenceEngine`` and ``serving/server.py --model``.  The joint
generation APIs, the fitted GMM prior and ``eval_statistics`` come with
ROADMAP Queue A item 6.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from multimodal_vae_comparison_tpu_torch.config import Config
from multimodal_vae_comparison_tpu_torch.data.datamodule import DataModule
from multimodal_vae_comparison_tpu_torch.device import resolve_device
from multimodal_vae_comparison_tpu_torch.training.trainer import (
    CKPT_FILE, build_model_from_config)


def find_run_dir(path: str) -> str:
    run_dir = path
    for _ in range(3):
        if os.path.exists(os.path.join(run_dir, "config.yml")):
            return run_dir
        run_dir = os.path.dirname(run_dir)
    if os.path.exists(os.path.join(run_dir, "config.yml")):
        return run_dir
    raise FileNotFoundError(f"no config.yml found at or above {path}")


class MultimodalVAEInfer:
    def __init__(self, path: str, ckpt: str = "last",
                 device: Optional[Union[str, torch.device]] = None):
        """:param path: run dir (results/<exp>/version_N) or a path inside it
        :param ckpt: checkpoint tag, "last" or "best"; the other one is
            taken when the requested one is absent
        :param device: CUDA unless the caller passes "cpu"
        """
        if ckpt not in ("last", "best"):
            raise ValueError(f"ckpt must be 'last' or 'best', got {ckpt!r}")
        self.device = resolve_device(device)
        self.run_dir = find_run_dir(path)
        self.config = Config(os.path.join(self.run_dir, "config.yml"), eval_only=True)
        self.config.mPath = self.run_dir
        self.datamod = DataModule(self.config)
        self.datamod.setup()
        self.model = build_model_from_config(self.config, self.device)
        # generation draws one sample: a K > 1 training objective would only
        # multiply every decode.  K shapes no weight.
        self.model.K = 1
        self.ckpt_path = self._find_ckpt(ckpt)
        state = torch.load(self.ckpt_path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["params"])
        self.model.eval()

    def _find_ckpt(self, tag: str) -> str:
        for t in (tag, {"last": "best", "best": "last"}[tag]):
            path = os.path.join(self.run_dir, "model", t, CKPT_FILE)
            if os.path.isfile(path):
                return path
        raise FileNotFoundError(f"no checkpoint under {self.run_dir}/model")

    @property
    def mod_names(self) -> Tuple[str, ...]:
        return self.model.mod_names

    def _tensor(self, x, dtype):
        if x is None:
            return None
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, dtype)

    def _full_batch(self, inputs: Dict[str, Dict]) -> Dict:
        batch = {}
        for name in self.mod_names:
            mod = inputs.get(name, {})
            batch[name] = {"data": self._tensor(mod.get("data"), torch.float32),
                           "masks": self._tensor(mod.get("masks"), torch.bool)}
        return batch

    def forward(self, inputs: Dict[str, Dict], present: Tuple[str, ...], eps=None,
                seed: int = 0):
        """The model's forward in eval mode, without a gradient; its noise
        is ``eps`` where given, else drawn from a generator seeded
        ``seed``."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        with torch.inference_mode():
            return self.model.forward(self._full_batch(inputs), present, eps=eps,
                                      generator=generator)

    def cross_generate(self, source_mod: str, data, masks=None) -> Dict[str, np.ndarray]:
        """Generate every modality from one source modality's data."""
        out = self.forward({source_mod: {"data": data, "masks": masks}},
                           present=(source_mod,))
        return {name: mo.decoder_dist.mean[0].cpu().numpy()
                for name, mo in out.mods.items() if mo.decoder_dist is not None}
