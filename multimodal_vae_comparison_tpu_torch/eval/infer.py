"""Restore a trained run for inference (counterpart of ``eval/infer.py``).

``MultimodalVAEInfer(path)`` finds the run directory's ``config.yml`` (at
``path`` or up to three levels above it), rebuilds the DataModule (whose
arrays give the modalities' feature dims) and the model, and loads the
port's own checkpoint, ``model/last/state.pt`` or ``model/best/state.pt``.
``MultimodalVAEInfer.from_trainer`` wraps a live Trainer the same way.
It serves ``InferenceEngine``, ``serving/server.py --model`` and the
benchmarks: cross-generation, joint generation from the learned prior, the
aggregate posterior (ex-post) or a GMM fitted to it, and seeded test
samples.

Every draw comes from a CPU ``torch.Generator`` seeded by the call's
``seed``, so the card and the CPU decode the same latents; each draw can
also be passed in (``idx``, ``eps``), which is how the tests give the port
the JAX package's draws.
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
        # eval and serving run fp32 whatever precision trained the run, as
        # the reference's do: a bf16 run's fp32 parameters restore as they are
        self.model = build_model_from_config(self.config, self.device, dtype=torch.float32)
        # generation draws one sample: a K > 1 training objective would only
        # multiply every decode.  K shapes no weight.
        self.model.K = 1
        self.ckpt_path = self._find_ckpt(ckpt)
        state = torch.load(self.ckpt_path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["params"])
        self.model.eval()
        self._expost_cache = None
        self._fitted_cache = None

    @classmethod
    def from_trainer(cls, trainer) -> "MultimodalVAEInfer":
        """The same APIs over a live Trainer's config, data, model and run
        directory; no checkpoint is read.  The model is the trainer's own (a
        caller that changes its ``K`` or mode restores them); under a compute
        dtype other than fp32 it is an fp32 model holding the trainer's
        weights, its ``K`` and mode, since eval runs fp32."""
        self = cls.__new__(cls)
        self.device = trainer.device
        self.run_dir = trainer.cfg.mPath
        self.config = trainer.cfg
        self.datamod = trainer.datamodule
        self.model = trainer.model
        if self.model.dtype != torch.float32:
            fp32 = build_model_from_config(trainer.cfg, trainer.device, dtype=torch.float32)
            fp32.load_state_dict(self.model.state_dict())
            fp32.K = self.model.K
            self.model = fp32.train(self.model.training)
        self.ckpt_path = None
        self._expost_cache = None
        self._fitted_cache = None
        return self

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
        is ``eps`` where given, else drawn from a CPU generator seeded
        ``seed``."""
        generator = torch.Generator().manual_seed(seed)
        with torch.inference_mode():
            return self.model.forward(self._full_batch(inputs), present, eps=eps,
                                      generator=generator)

    def cross_generate(self, source_mod: str, data, masks=None,
                       eps=None) -> Dict[str, np.ndarray]:
        """Generate every modality from one source modality's data; ``eps``
        is the forward's noise (see :meth:`forward`)."""
        out = self.forward({source_mod: {"data": data, "masks": masks}},
                           present=(source_mod,), eps=eps)
        return {name: mo.decoder_dist.mean[0].cpu().numpy()
                for name, mo in out.mods.items() if mo.decoder_dist is not None}

    def joint_generate(self, num_samples: int, seed: int = 0, source: str = "prior",
                       temperature: float = 1.0, idx=None, eps=None
                       ) -> Dict[str, np.ndarray]:
        """Decode latent samples with every decoder (joint generation).

        ``source="prior"``: draws of the learned prior (:meth:`MMVAE.sample_pz`);
        ``"expost"``: draws of the aggregate posterior, a mixture over the
        stored per-row posteriors of the train split (:meth:`_expost_prior`);
        ``"fitted"``: draws of a diagonal GMM fitted after training to
        samples of that aggregate posterior (:meth:`_fitted_prior`).
        ``temperature`` scales the sampling standard deviation.

        The draws come from a CPU generator seeded ``seed``: for the
        Gaussian prior ``eps`` (1, num, D); for the mixtures (a mixture prior
        of ``prior_components > 1`` among them) the component ``idx``
        (num,), then ``eps`` (num, D).  Either may be passed in instead.
        """
        generator = torch.Generator().manual_seed(seed)
        if source in ("expost", "fitted"):
            if source == "expost":
                loc, scale = self._expost_prior()
                if idx is None:
                    idx = torch.randint(len(loc), (num_samples,), generator=generator)
            else:
                loc, scale, logw = self._fitted_prior()
                if idx is None:
                    probs = np.exp(logw - logw.max())
                    idx = torch.multinomial(torch.from_numpy(probs / probs.sum()),
                                            num_samples, replacement=True,
                                            generator=generator)
            if eps is None:
                eps = torch.randn(num_samples, self.model.n_latents, generator=generator)
            idx, eps = np.asarray(idx), np.asarray(eps, np.float32)
            z = torch.from_numpy((loc[idx] + temperature * scale[idx] * eps)[None])
        elif source == "prior":
            with torch.inference_mode():
                z = self.model.sample_pz(num_samples, temperature, generator=generator,
                                         eps=None if eps is None else torch.as_tensor(eps),
                                         idx=None if idx is None else torch.as_tensor(idx))
        else:
            raise ValueError(f"source must be 'prior', 'expost' or 'fitted', got {source!r}")
        z = z.to(self.device)
        with torch.inference_mode():
            return {name: self.model.decode_mod(name, z).mean[0].cpu().numpy()
                    for name in self.mod_names}

    def _expost_prior(self, max_samples: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
        """(loc, scale) rows of the per-row posteriors over the first
        ``max_samples`` rows of the train split, in 64-row batches (the last
        one padded, as the DataModule pads): the components of the
        aggregate posterior mixture.  The joint posterior where the model
        has one (POE, POE2 and DMVAE: the product of experts; MoPOE: the
        stratified mixture of its subsets' products), else every modality's
        own (MOE).  Cached."""
        if self._expost_cache is not None:
            return self._expost_cache
        mus, scales = [], []
        seen = 0
        D = self.model.n_latents
        for batch in self.datamod.batches("train", batch_size=64, drop_remainder=False):
            out = self.forward({n: batch[n] for n in self.mod_names},
                               present=tuple(self.mod_names))
            for name in self.mod_names:
                mo = out.mods[name]
                dist = mo.joint_dist or mo.encoder_dist
                if dist is None:
                    continue
                mus.append(dist.loc[..., :D].reshape(-1, D).cpu().numpy())
                scales.append(dist.scale[..., :D].reshape(-1, D).cpu().numpy())
                if mo.joint_dist is not None:
                    break   # one fused posterior covers all modalities
            seen += 64
            if seen >= max_samples:
                break
        self._expost_cache = (np.concatenate(mus, 0).astype(np.float32),
                              np.concatenate(scales, 0).astype(np.float32))
        return self._expost_cache

    def _fitted_prior(self, components: int = 16, samples_per_row: int = 4,
                      iters: int = 75, seed: int = 0):
        """A ``components``-component diagonal GMM fitted by EM to
        ``samples_per_row`` draws of each ex-post component: (loc (C, D),
        scale (C, D), log_weights (C,)).  Cached."""
        if self._fitted_cache is not None:
            return self._fitted_cache
        mus, scales = self._expost_prior()
        rng = np.random.default_rng(seed)
        eps = rng.standard_normal((samples_per_row,) + mus.shape)
        x = (mus[None] + scales[None] * eps).reshape(-1, mus.shape[-1])
        self._fitted_cache = _fit_diag_gmm(x.astype(np.float64), components, iters=iters,
                                          seed=seed)
        return self._fitted_cache

    def get_test_samples(self, n: int, split: str = "test", seed: int = 0):
        """(batch, labels) of a seeded random subset of ``n`` rows of the
        split (the val split where there is no test file), capped at the
        split's size; labels None where the dataset has none.  A first-n
        read would be factor-skewed: the generator writes the factor
        product in order."""
        if split == "test" and self.datamod._test is None:
            split = "val"
        data = {"test": self.datamod._test, "val": self.datamod._val,
                "train": self.datamod._train}[split]
        total = len(data[0]["data"])
        n = min(n, total)
        idx = np.random.default_rng(seed).permutation(total)[:n]
        batch = self.datamod._make_batch(data, idx)
        labels = {"test": self.datamod.labels_test, "val": self.datamod.labels_val,
                  "train": self.datamod.labels_train}[split]
        if labels is None or not len(labels):
            return batch, None
        return batch, np.asarray(labels)[idx]

    def get_wrapped_model(self):
        """The reference returns a wrapper module; here the infer object is it."""
        return self

    def eval_statistics(self):
        """The dataset's own benchmark on this run."""
        fn = self.datamod.datasets[0].eval_statistics_fn()
        if fn is None:
            raise ValueError(f"{type(self.datamod.datasets[0]).__name__} has no benchmark")
        return fn(self)


def _fit_diag_gmm(x: np.ndarray, C: int, iters: int = 75, seed: int = 0,
                 min_var: float = 1e-4):
    """Diagonal-covariance GMM by EM, in numpy (a copy of the JAX package's
    ``_fit_diag_gmm``, bit for bit): random-row init, a variance floor,
    deterministic under ``seed``.  Returns (loc (C, D) f32, scale (C, D)
    f32, log_weights (C,) f32)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    n, d = x.shape
    C = min(C, n)
    loc = x[rng.choice(n, C, replace=False)].copy()
    var = np.tile(x.var(0) + 1e-3, (C, 1))
    logw = np.full(C, -np.log(C))
    for _ in range(iters):
        diff = x[:, None, :] - loc[None]                       # (N, C, D)
        ll = (-0.5 * ((diff ** 2) / var[None]).sum(-1)
              - 0.5 * np.log(2.0 * np.pi * var).sum(-1)[None]
              + logw[None])                                    # (N, C)
        ll -= ll.max(axis=1, keepdims=True)
        r = np.exp(ll)
        r /= r.sum(axis=1, keepdims=True)
        nk = r.sum(0) + 1e-8                                   # (C,)
        loc = (r.T @ x) / nk[:, None]
        var = np.maximum((r.T @ (x ** 2)) / nk[:, None] - loc ** 2, min_var)
        logw = np.log(nk / n)
    return (loc.astype(np.float32), np.sqrt(var).astype(np.float32),
            logw.astype(np.float32))
