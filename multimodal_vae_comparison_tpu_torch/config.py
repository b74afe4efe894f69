"""YAML config (counterpart of ``config.py``).

A copy of the JAX package's ``Config``: the port imports nothing of that
package.  One YAML file holds the top-level keys (batch_size, epochs, lr,
n_latents, mixing, obj, optimizer, seed, ...) and one ``modality_n`` block
per modality; CLI flags that name a key replace its value.  A run directory
``<results_root>/<exp_name>/version_N`` gets a ``config.yml`` copy, so that a
restore (``eval/infer.py``, ``serving/server.py --model``) rebuilds the same
model.  PyYAML is imported where a file is read or written.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

# Per-modality defaults applied by the reference (config_cls.py:76-89).
_MOD_DEFAULTS = {
    "private_latents": None,
    "llik_scaling": 1,
    "prior": "normal",
    "test_datapath": None,
    "cond_on": None,
    "cond_always": False,
}

# required in every YAML; also CLI-overridable even when absent from it
_REQUIRED_KEYS = ("batch_size", "epochs", "lr", "n_latents")

_TOP_DEFAULTS = {
    "K": 1,
    "beta": 1.0,
    "seed": 1,
    "iterseeds": 1,
    "viz_freq": 1,
    "test_split": 0.1,
    "labels": None,
    "pre_trained": None,
    "optimizer": "adam",
    "obj": "elbo",
    "mixing": "moe",
    "exp_name": "experiment",
    "dataset_name": None,
    "precision": "32",
    "num_devices": None,          # None = all visible devices
    "prefetch": 2,                # host->device prefetch depth
    "donate_state": True,
    "log_every": 50,
    # None = auto (whole epochs resident on the device when the train split
    # fits in 4 GiB)
    "scan_epochs": None,
    "ckpt_freq": 1,
    "remat": False,
    # restart from this run dir's own last checkpoint if present
    "resume": False,
    # weight of the auxiliary endpoint-supervision loss (POE only)
    "aux_endpoint": 0.0,
    # >1 = learnable mixture-of-Gaussians prior with this many components
    "prior_components": 1,
    # >1 = split each batch into this many strided microbatches and take one
    # update from their mean gradient
    "grad_accum": 1,
}


@dataclasses.dataclass
class ModalityConfig:
    """One ``modality_n`` block of the YAML config."""

    encoder: str
    decoder: str
    path: Optional[str] = None
    mod_type: str = "image"
    recon_loss: str = "bce"
    prior: str = "normal"
    llik_scaling: Any = 1
    private_latents: Optional[int] = None
    test_datapath: Optional[str] = None
    # decode this modality conditioned on another modality's raw data
    # (value: the other modality's mod_type or mod_n name)
    cond_on: Optional[str] = None
    # supply the conditioning on every subset objective whenever the batch
    # carries the data (default: only when the cond modality is in the subset)
    cond_always: bool = False
    # filled in by the data module from the dataset's arrays
    feature_dims: Optional[List[int]] = None

    @property
    def name(self) -> str:
        return self._name

    def with_name(self, name: str) -> "ModalityConfig":
        self._name = name
        return self


class Config:
    """Parses a YAML path, a run dir holding ``config.yml``, or a dict into
    a typed config; ``overrides`` replace the values of the keys they name
    (None values are ignored)."""

    def __init__(self, source, overrides: Optional[Dict[str, Any]] = None,
                 eval_only: bool = False, results_root: str = "results"):
        self.eval_only = eval_only
        self.results_root = results_root
        self.params = self._load(source)
        if overrides:
            for name, value in overrides.items():
                # a known key absent from the YAML is still overridable
                if value is not None and name != "cfg" and (
                        name in self.params or name in _TOP_DEFAULTS
                        or name in _REQUIRED_KEYS):
                    self.params[name] = value
        self._define_params()
        self.mPath: Optional[str] = None
        if not eval_only:
            self._setup_savedir()

    # -- parsing ------------------------------------------------------------

    @staticmethod
    def _load(source) -> Dict[str, Any]:
        if isinstance(source, dict):
            return dict(source)
        if isinstance(source, str):
            if os.path.isdir(source):
                source = os.path.join(source, "config.yml")
            if not os.path.isfile(source):
                raise ValueError(f"{source} is not a valid config path")
            import yaml
            with open(source) as f:
                return yaml.safe_load(f)
        raise ValueError(f"unsupported config source: {type(source)}")

    def _define_params(self) -> None:
        for key, default in _TOP_DEFAULTS.items():
            setattr(self, key, self.params.get(key, default))
        for key, value in self.params.items():
            if not key.startswith("modality_"):
                setattr(self, key, value)
        for key in _REQUIRED_KEYS:
            if key not in self.params:
                raise ValueError(f"config is missing required key '{key}'")
            setattr(self, key, self.params[key])
        self.lr = float(self.lr)
        self.beta = float(self.beta)
        self.K = int(self.K)
        self.n_latents = int(self.n_latents)
        self.mods: List[ModalityConfig] = []
        mod_keys = sorted(k for k in self.params if k.startswith("modality_"))
        known = {f.name for f in dataclasses.fields(ModalityConfig)}
        for i, key in enumerate(mod_keys):
            block = dict(_MOD_DEFAULTS)
            block.update(self.params[key] or {})
            extra = {k: v for k, v in block.items() if k not in known}
            block = {k: v for k, v in block.items() if k in known}
            mc = ModalityConfig(**block).with_name(f"mod_{i + 1}")
            mc.extra = extra
            self.mods.append(mc)
        if not self.mods:
            raise ValueError("config must define at least one modality_n block")
        self.num_mods = len(self.mods)

    # -- run dir ------------------------------------------------------------

    def find_version(self) -> int:
        version = 0
        base = os.path.join(self.results_root, self.exp_name)
        while os.path.exists(os.path.join(base, f"version_{version}")):
            version += 1
        return version

    def _setup_savedir(self) -> None:
        version = self.find_version()
        self.mPath = os.path.join(self.results_root, self.exp_name,
                                  f"version_{version}")
        os.makedirs(self.mPath, exist_ok=True)
        os.makedirs(os.path.join(self.mPath, "visuals"), exist_ok=True)
        self.dump_config()

    def dump_config(self) -> None:
        import yaml
        with open(os.path.join(self.mPath, "config.yml"), "w") as f:
            yaml.dump(self.params, f, default_flow_style=False)

    def get_vis_dir(self) -> str:
        return os.path.join(self.mPath, "visuals")

    def change_seed(self, seed: int) -> None:
        self.seed = seed
        self.params["seed"] = seed
