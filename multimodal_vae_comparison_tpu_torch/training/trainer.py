"""Model assembly, the train/eval steps, the epoch runners and the Trainer
(counterpart of ``training/trainer.py``).

    model = build_model(specs, "poe", n_latents=16, obj="elbo", device="cuda")
    opt = make_optimizer("adam", 1e-3, model.parameters())
    step = make_train_step(model, opt)
    metrics = step(batch)          # {"loss": ..., "kld": ..., ...} tensors

    trainer = Trainer(Config("configs/round5/cdl1_r5_poe.yml"))
    trainer.fit()                  # epochs, validation, CSV, checkpoints

A batch is ``{"mod_1": {"data": tensor, "masks": tensor or None}, ...}`` on
the model's device.  PyTorch runs eagerly, so a step is a plain function:
objective, backward, one optimizer update.  The Trainer drives it from a
config through the data layer, as the reference's does:

* a train split that fits in 4 GiB is staged on the device once and each
  epoch runs over it with one on-device reshuffle (:func:`make_epoch_runner`);
  a larger one streams per batch through :func:`prefetch_to_device`, with
  the host shuffle of the JAX package;
* metrics are summed on the device and read by the host once per epoch;
* checkpoints hold params, optimizer state, step and the best validation
  loss (``<run>/model/{last,best}/state.pt``, ``torch.save``); ``pre_trained``
  warm-starts the params and ``resume`` restarts a run from its own state;
* CSV metrics, and TensorBoard when ``tensorboardX`` imports;
* every ``viz_freq`` epochs the visualizations of ``visualization.py``,
  and at the end :meth:`Trainer.test`: validation, then the dataset's own
  benchmark (CdSprites+: ``eval/eval_cdsprites.py``).
"""
from __future__ import annotations

import os
import time
import traceback
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from multimodal_vae_comparison_tpu_torch.data.datamodule import (
    DataModule, prefetch_to_device)
from multimodal_vae_comparison_tpu_torch.device import resolve_device
from multimodal_vae_comparison_tpu_torch.eval.weights import install_pretrained
from multimodal_vae_comparison_tpu_torch.models import get_mixing, objectives
from multimodal_vae_comparison_tpu_torch.models.base import MMVAE, ModalitySpec, build_specs
from multimodal_vae_comparison_tpu_torch.models.mmvae import UnimodalVAE
from multimodal_vae_comparison_tpu_torch.ops.kernels import telemetry
from multimodal_vae_comparison_tpu_torch.parallel import rows
from multimodal_vae_comparison_tpu_torch.parallel.mesh import local_rows, shard_params
from multimodal_vae_comparison_tpu_torch.training.optim import local_shard, make_optimizer

CKPT_FILE = "state.pt"


def build_model(specs: Tuple[ModalitySpec, ...], mixing: str, n_latents: int,
                obj: str = "elbo", beta: float = 1.0, K: int = 1, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None,
                remat: bool = False, prior_components: int = 1,
                aux_endpoint: float = 0.0, dtype: torch.dtype = torch.float32) -> MMVAE:
    """The model of a config: the mixing class named by ``mixing`` (poe,
    moe, mopoe, dmvae or poe2) over one VAE per modality spec, weights drawn
    from ``seed``, on ``device`` (CUDA unless the caller passes ``"cpu"``);
    ``remat`` recomputes the nets' activations in the backward pass instead
    of keeping them; ``prior_components > 1`` learns a mixture-of-Gaussians
    prior of that many components; ``aux_endpoint > 0`` adds the endpoint
    head, which POE's objective trains with that weight; ``dtype`` is the
    nets' compute dtype (bf16, or fp32), the parameters fp32 either way.  One
    modality spec builds :class:`UnimodalVAE`, whatever ``mixing`` names."""
    cls = UnimodalVAE if len(specs) == 1 else get_mixing(mixing)
    return cls(specs, n_latents, K=K, seed=seed, device=device, obj=obj, beta=beta,
               remat=remat, prior_components=prior_components,
               aux_endpoint=aux_endpoint, dtype=dtype)


def precision_dtype(precision) -> torch.dtype:
    """The compute dtype of a config's ``precision``, as the reference maps
    it: ``bf16`` and ``bfloat16`` are bf16, anything else (``32``, ``16``,
    ``64``, none) fp32."""
    return torch.bfloat16 if str(precision) in ("bf16", "bfloat16") else torch.float32


def build_model_from_config(cfg, device: Optional[Union[str, torch.device]] = None,
                            dtype: Optional[torch.dtype] = None) -> MMVAE:
    """:func:`build_model` from a parsed Config whose modalities carry their
    ``feature_dims`` (``DataModule.setup`` fills them in); weights are drawn
    from ``cfg.seed``.  The compute dtype is ``dtype``, or without one the
    config's ``precision`` (:func:`precision_dtype`): the Trainer trains in
    it, while eval and serving pass fp32.  An unknown reconstruction loss
    raises."""
    if dtype is None:
        dtype = precision_dtype(getattr(cfg, "precision", "32"))
    for m in cfg.mods:
        objectives.check_ported(m.recon_loss)
    return build_model(build_specs(cfg), cfg.mixing, cfg.n_latents, obj=cfg.obj,
                       beta=cfg.beta, K=cfg.K, seed=cfg.seed, device=device,
                       remat=bool(getattr(cfg, "remat", False)),
                       prior_components=int(getattr(cfg, "prior_components", 1) or 1),
                       aux_endpoint=float(getattr(cfg, "aux_endpoint", 0.0) or 0.0),
                       dtype=dtype)


def _chunk(batch, eps, start: int, G: int):
    """The strided chunk of rows ``start, start + G, ...`` (the reference
    splits a batch into chunks ``x[g::G]``); injected (K, B, D) draws are
    split the same way."""
    sub = {name: {k: None if v is None else v[start::G] for k, v in mod.items()}
           for name, mod in batch.items()}
    if eps is None:
        return sub, None
    if isinstance(eps, dict):
        return sub, {k: e[:, start::G] for k, e in eps.items()}
    return sub, [e[:, start::G] for e in eps]


def _batch_size(batch) -> int:
    return next(mod["data"].shape[0] for mod in batch.values()
                if mod.get("data") is not None)


def _data_axis(group) -> Tuple[int, int]:
    """(this rank's index, the size) of the data axis ``group`` (None: one
    device)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _row_shard(group, start: int, total: int):
    """The shard of rows ``[start, ...)`` of ``total`` on the data axis, or
    None on one device (the one-device computation, bit for bit)."""
    return None if _data_axis(group)[1] == 1 else rows.RowShard(start, total, group)


def _all_reduce_sums(values, group) -> None:
    """Sum the tensors ``values`` over the data axis in place, in one
    collective per dtype and device."""
    buckets = {}
    for v in values:
        buckets.setdefault((v.dtype, v.device), []).append(v)
    for vs in buckets.values():
        flat = torch.cat([v.reshape(-1) for v in vs])
        dist.all_reduce(flat, group=group)
        for v, part in zip(vs, flat.split([v.numel() for v in vs])):
            v.copy_(part.view_as(v))


def make_train_step(model: MMVAE, opt: torch.optim.Optimizer, grad_accum: int = 1,
                    data_group=None):
    """``step(batch, eps=None, generator=None) -> metrics``: the model's
    objective, its gradient, and one optimizer update; ``metrics`` holds the
    objective's metrics and ``loss``, as detached tensors.

    With ``grad_accum = G > 1`` the batch splits into G strided chunks
    (chunk g is ``x[g::G]``); each chunk's gradient is summed, the sum is
    scaled by 1/G and one update is taken, and the loss and metrics are
    the chunks' mean.  A batch that G does not divide raises.

    With a ``data_group`` of N ranks (the data axis of a mesh) ``batch``
    and ``eps`` hold this rank's rows, block r of the global batch
    (``parallel/mesh.shard_batch``), and the step is the global batch's:
    the noise is drawn at the global shape and the rank's rows kept, row
    means are the global batch's (``parallel/rows.py``), and since the
    loss is a sum over rows, the gradient, the loss and every metric are
    SUMMED over the ranks (not averaged, as DDP does).  Chunk g on rank r
    is the rank's rows whose global index is g mod G.
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch, eps=None, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        model.train()
        opt.zero_grad(set_to_none=True)
        n = _batch_size(batch)
        r, N = _data_axis(data_group)
        if grad_accum == 1:
            with rows.shard_rows(_row_shard(data_group, r * n, N * n)):
                loss, metrics = model.objective(batch, eps=eps, generator=generator)
            loss.backward()
            out = {k: v.detach() for k, v in metrics.items()}
            out["loss"] = loss.detach()
        else:
            if (N * n) % grad_accum:
                raise ValueError(f"batch {N * n} is not divisible by "
                                 f"grad_accum={grad_accum}")
            if n < grad_accum:
                raise ValueError(f"{n} rows a rank cannot make {grad_accum} chunks")
            out = {}
            for g in range(grad_accum):
                first = (g - r * n) % grad_accum      # the rank's first row of chunk g
                sub, sub_eps = _chunk(batch, eps, first, grad_accum)
                shard = _row_shard(data_group, (r * n + first) // grad_accum,
                                   N * n // grad_accum)
                with rows.shard_rows(shard):
                    loss, metrics = model.objective(sub, eps=sub_eps, generator=generator)
                loss.backward()
                metrics = dict(metrics, loss=loss)
                for k, v in metrics.items():
                    out[k] = out.get(k, 0.0) + v.detach()
            inv = 1.0 / grad_accum
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(inv)
            out = {k: v * inv for k, v in out.items()}
        if N > 1:
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            _all_reduce_sums([local_shard(p.grad) for p in params], data_group)
            out = _all_reduced_metrics(out, data_group)
        opt.step()
        return out

    return step


def _all_reduced_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    keys = sorted(metrics)
    values = [metrics[k].float().reshape(1).clone() for k in keys]
    _all_reduce_sums(values, group)
    return {k: v.reshape(()) for k, v in zip(keys, values)}


def make_eval_step(model: MMVAE, data_group=None):
    """``eval_step(batch, eps=None, generator=None) -> metrics``: the
    objective's metrics and ``loss`` without a gradient; with a
    ``data_group`` the global batch's, as :func:`make_train_step`'s."""

    def eval_step(batch, eps=None, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        model.eval()
        n = _batch_size(batch)
        r, N = _data_axis(data_group)
        with torch.no_grad(), rows.shard_rows(_row_shard(data_group, r * n, N * n)):
            loss, metrics = model.objective(batch, eps=eps, generator=generator)
        out = dict(metrics)
        out["loss"] = loss
        return _all_reduced_metrics(out, data_group) if N > 1 else out

    return eval_step


def _accumulate(total: Dict[str, torch.Tensor], metrics: Dict[str, torch.Tensor]) -> None:
    for k, v in metrics.items():
        total[k] = v if k not in total else total[k] + v


def _host_means(total: Dict[str, torch.Tensor], count: int) -> Dict[str, float]:
    """The per-step means of summed device metrics, in one host read."""
    keys = sorted(total)
    values = torch.stack([total[k].float() for k in keys]).cpu().tolist()
    return {k: v / count for k, v in zip(keys, values)}


def _batch_at(staged, i: int):
    return {name: {k: None if v is None else v[i] for k, v in mod.items()}
            for name, mod in staged.items()}


def make_epoch_runner(step, reshuffle: bool = True):
    """Whole-epoch runner over a staged split (counterpart of
    ``trainer.py:151-189``): ``epoch_fn(staged, generator) -> {metric: mean}``.

    ``staged`` holds each modality's ``(n_batches, bs, ...)`` tensors on the
    device.  With ``reshuffle`` the samples are permuted once per epoch on
    the device (``torch.randperm`` from ``generator``, one permutation
    shared by all modalities), then ``step`` runs over the batches in order,
    drawing its noise from the same generator; the metrics are summed on the
    device and read by the host once.
    """

    def epoch_fn(staged, generator: torch.Generator) -> Dict[str, float]:
        leaf = next(mod["data"] for mod in staged.values())
        n_batches, bs = leaf.shape[:2]
        if reshuffle:
            perm = torch.randperm(n_batches * bs, generator=generator, device=leaf.device)
            staged = {name: {k: None if v is None
                             else v.flatten(0, 1).index_select(0, perm).view(v.shape)
                             for k, v in mod.items()}
                      for name, mod in staged.items()}
        total = {}
        for i in range(n_batches):
            _accumulate(total, step(_batch_at(staged, i), generator=generator))
        return _host_means(total, n_batches)

    return epoch_fn


def make_eval_runner(eval_step):
    """Whole-val-split evaluation over a staged split (counterpart of
    ``trainer.py:205-216``): ``eval_fn(staged, generator) -> {metric: mean}``,
    one host read."""

    def eval_fn(staged, generator: torch.Generator) -> Dict[str, float]:
        n_batches = next(mod["data"] for mod in staged.values()).shape[0]
        total = {}
        for i in range(n_batches):
            _accumulate(total, eval_step(_batch_at(staged, i), generator=generator))
        return _host_means(total, n_batches)

    return eval_fn


class CSVLogger:
    """Minimal CSV metrics sink (reference's CSVLogger analog)."""

    def __init__(self, path: str):
        self.path = path
        self._keys = None
        os.makedirs(os.path.dirname(path), exist_ok=True)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        metrics = {"step": step, **metrics}
        if self._keys is None:
            # resume-safe: append to an existing file (reusing its header
            # key order) instead of truncating the earlier epochs' rows
            existing = None
            if os.path.exists(self.path):
                with open(self.path) as f:
                    existing = f.readline().strip()
            if existing:
                self._keys = existing.split(",")
            else:
                self._keys = list(metrics.keys())
                with open(self.path, "w") as f:
                    f.write(",".join(self._keys) + "\n")
        with open(self.path, "a") as f:
            f.write(",".join(str(metrics.get(k, "")) for k in self._keys) + "\n")


def data_parallel_size(cfg, device: Optional[Union[str, torch.device]] = None) -> int:
    """The ranks a config trains on (reference ``trainer.py:252-257``):
    ``num_devices``, or when it is None every card (one CPU), shrunk until
    it divides ``batch_size``.  More cards than the host has raises."""
    on_cards = resolve_device(device).type == "cuda"
    n = int(getattr(cfg, "num_devices", None)
            or (torch.cuda.device_count() if on_cards else 1))
    if on_cards and n > torch.cuda.device_count():
        raise ValueError(f"num_devices {n} is more than the {torch.cuda.device_count()} "
                         "cards of this host")
    while cfg.batch_size % n:
        n -= 1
    return n


class Trainer:
    """Training from a parsed Config (counterpart of ``trainer.py:246-620``).

    ``device`` defaults to CUDA and raises when there is none.  The model's
    weights are drawn from ``cfg.seed`` by :meth:`init_state`, which
    :meth:`fit` calls when the caller has not.

    In a rank of an initialized process group (``main --num_devices N``
    starts N through ``parallel/launch.py``) the Trainer trains data
    parallel over the group's ranks, as the reference does over its data
    mesh: every rank holds the model, steps on its block of each global
    batch (:func:`make_train_step` with the group), and reads the same
    global metrics; every rank shuffles with the same seed.  Rank 0 alone
    writes the checkpoints (the one-device state), the CSV, TensorBoard
    and the visualizations, and runs the benchmark of :meth:`test`.
    Outside a process group it trains on one device, and a config that
    asks for more raises.
    """

    def __init__(self, cfg, datamodule: Optional[DataModule] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 enable_viz: bool = True):
        self.data_group = dist.group.WORLD if dist.is_initialized() else None
        self.rank, self.world = _data_axis(self.data_group)
        if self.data_group is None and int(getattr(cfg, "num_devices", None) or 1) > 1:
            raise ValueError(f"num_devices {cfg.num_devices} needs that many ranks: train "
                             "through main --num_devices, or build the Trainer in the "
                             "ranks of parallel.launch.launch")
        if cfg.batch_size % self.world:
            raise ValueError(f"batch_size {cfg.batch_size} does not split over "
                             f"{self.world} ranks")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.datamodule = datamodule or DataModule(cfg)
        self.datamodule.setup()
        self.model = build_model_from_config(cfg, self.device)
        # the seed's fresh weights, which init_state loads until the seed changes
        self._fresh = (cfg.seed, {k: v.clone() for k, v in self.model.state_dict().items()})
        self.opt = make_optimizer(cfg.optimizer, cfg.lr, self.model.parameters())
        accum = int(getattr(cfg, "grad_accum", 1) or 1)
        self.train_step = make_train_step(self.model, self.opt, grad_accum=accum,
                                          data_group=self.data_group)
        self.eval_step = make_eval_step(self.model, data_group=self.data_group)
        self.reshuffle = bool(getattr(cfg, "reshuffle", True))
        # the staged splits are whole on every rank (the reshuffle moves rows
        # between ranks); each step takes the rank's block
        self.epoch_runner = make_epoch_runner(
            lambda batch, generator: self.train_step(self._block(batch), generator=generator),
            reshuffle=self.reshuffle)
        self.eval_runner = make_eval_runner(
            lambda batch, generator: self.eval_step(self._block(batch), generator=generator))
        self._staged_epoch = None
        self._staged_val = None
        self.enable_viz = enable_viz
        self.step: Optional[int] = None     # None until init_state
        self.best_val = float("inf")
        self.csv: Optional[CSVLogger] = None
        self._tb = None
        if cfg.mPath:
            self._open_loggers(cfg.mPath)

    def _block(self, batch):
        """This rank's block of a global batch (the batch on one device)."""
        if self.world == 1:
            return batch
        return {name: {k: None if v is None else local_rows(v, self.rank, self.world)
                       for k, v in mod.items()}
                for name, mod in batch.items()}

    def close(self) -> None:
        """Close the TensorBoard writer (its thread must end before a rank's
        process does)."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def _open_loggers(self, mPath: str) -> None:
        if self.rank:
            return
        self.csv = CSVLogger(os.path.join(mPath, "metrics.csv"))
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(logdir=os.path.join(mPath, "tb"))

    # -- state ------------------------------------------------------------------

    def reset_for_seed(self, seed: int, mPath: Optional[str] = None) -> None:
        """Re-seed for an iterseeds run with the same Trainer: reshuffles the
        data, clears the staged splits, redraws the weights and, with
        ``mPath``, points the config dump and both loggers at the new run
        directory."""
        self.cfg.change_seed(seed)
        if mPath is not None:
            self.cfg.mPath = mPath
            if self.rank == 0:
                os.makedirs(os.path.join(mPath, "visuals"), exist_ok=True)
                self.cfg.dump_config()
            self._open_loggers(mPath)
        self.datamodule = DataModule(self.cfg)
        self.datamodule.setup()
        self._staged_epoch = None
        self._staged_val = None
        self.best_val = float("inf")
        self.init_state()

    def init_state(self) -> "Trainer":
        """Fresh weights from ``cfg.seed`` and a fresh optimizer, at step 0;
        the ImageNet ResNet-50 loaded into every ``Enc_CNN`` trunk where a
        ``resnet50`` file is installed (``eval/weights.install_pretrained``;
        a no-op without one, and a file that does not fit raises); then the
        ``pre_trained`` params, or with ``resume`` this run's own last
        checkpoint (params, optimizer state, step, best_val)."""
        seed, fresh = self._fresh
        if seed != self.cfg.seed:
            fresh = build_model_from_config(self.cfg, "cpu").state_dict()
            self._fresh = (self.cfg.seed, fresh)
        self.model.load_state_dict(fresh)
        install_pretrained(self.model)
        self.opt.state.clear()
        self.step = 0
        if getattr(self.cfg, "pre_trained", None):
            self.restore_params(self.cfg.pre_trained)
        elif (getattr(self.cfg, "resume", False) and self.cfg.mPath
              and os.path.isfile(os.path.join(self._ckpt_dir("last"), CKPT_FILE))):
            self.restore_state(self.cfg.mPath)
        if self.world > 1:
            shard_params(self.model)
        return self

    def n_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    # -- checkpoints --------------------------------------------------------------

    def _ckpt_dir(self, tag: str) -> str:
        return os.path.join(os.path.abspath(self.cfg.mPath), "model", tag)

    def save_checkpoint(self, tag: str = "last") -> None:
        """Params, optimizer state, step and best_val into
        ``<mPath>/model/<tag>/state.pt``, replaced in one rename (rank 0's;
        the other ranks write nothing)."""
        if self.rank:
            return
        path = os.path.join(self._ckpt_dir(tag), CKPT_FILE)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        # through a file object: torch.save names the archive inside the file
        # after a path it is given, and this one holds the process id
        with open(tmp, "wb") as f:
            torch.save({"params": self.model.state_dict(), "opt_state": self.opt.state_dict(),
                        "step": self.step, "best_val": self.best_val}, f)
        os.replace(tmp, path)

    @staticmethod
    def _resolve_ckpt(path: str) -> str:
        """The checkpoint file of a run dir (its ``model/last``), of a
        checkpoint dir, or the file itself."""
        if os.path.isdir(os.path.join(path, "model", "last")):
            path = os.path.join(path, "model", "last")
        if os.path.isdir(path):
            path = os.path.join(path, CKPT_FILE)
        return os.path.abspath(path)

    def _load(self, path: str) -> dict:
        return torch.load(self._resolve_ckpt(path), map_location=self.device,
                          weights_only=True)

    def restore_params(self, path: str) -> None:
        """Params only (the ``pre_trained`` warm start)."""
        self.model.load_state_dict(self._load(path)["params"])

    def restore_state(self, path: str) -> None:
        """The whole state, for a restart: params, optimizer state (moments
        and counts), step and the best validation loss."""
        ckpt = self._load(path)
        self.model.load_state_dict(ckpt["params"])
        self.opt.load_state_dict(ckpt["opt_state"])
        self.step = int(ckpt["step"])
        self.best_val = float(ckpt["best_val"])

    # -- logging ------------------------------------------------------------------

    def _log(self, step: int, metrics: Dict[str, float]) -> None:
        if self.csv:
            self.csv.log(step, metrics)
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    # -- the resident path ---------------------------------------------------------

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _train_bytes(self) -> int:
        total = 0
        for mod in self.datamodule._train:
            total += mod["data"].nbytes
            if mod["masks"] is not None:
                total += mod["masks"].nbytes
        return total

    def use_scan(self) -> bool:
        """Whole epochs on the device: ``scan_epochs`` when set, else when
        the train split fits in 4 GiB."""
        flag = getattr(self.cfg, "scan_epochs", None)
        if flag is not None:
            return bool(flag)
        return self._train_bytes() < 4 * 1024 ** 3

    def _stage(self, split, n_batches: int):
        bs = self.cfg.batch_size
        staged = {}
        for i, mod in enumerate(split):
            entry = {}
            for key, arr in mod.items():
                if arr is not None:
                    arr = np.ascontiguousarray(arr[: n_batches * bs])
                    arr = torch.from_numpy(arr.reshape(n_batches, bs, *arr.shape[1:]))
                    arr = arr.to(self.device)
                entry[key] = arr
            staged[f"mod_{i + 1}"] = entry
        return staged

    def stage_epoch_data(self):
        """The train split's full batches as ``(n_batches, bs, ...)`` tensors
        on the device, staged once."""
        if self._staged_epoch is None:
            self._staged_epoch = self._stage(
                self.datamodule._train, self.datamodule.n_train // self.cfg.batch_size)
        return self._staged_epoch

    def stage_val_data(self):
        """The val split's full batches on the device, or None when it has
        no full batch."""
        if self._staged_val is None:
            n_batches = self.datamodule.n_val // self.cfg.batch_size
            if n_batches == 0:
                return None
            self._staged_val = self._stage(self.datamodule._val, n_batches)
        return self._staged_val

    def run_epoch_scan(self, epoch: int) -> Dict[str, float]:
        staged = self.stage_epoch_data()
        metrics = self.epoch_runner(staged, self._generator(self.cfg.seed * 100003 + epoch))
        self.step += next(mod["data"] for mod in staged.values()).shape[0]
        return {f"train_{k}": v for k, v in metrics.items()}

    def validate_scan(self, epoch: int) -> Dict[str, float]:
        staged = self.stage_val_data()
        if staged is None:
            return self.validate(epoch)
        metrics = self.eval_runner(staged, self._generator(7 + epoch))
        return {f"val_{k}": v for k, v in metrics.items()}

    # -- the per-batch path ----------------------------------------------------------

    def run_epoch(self, epoch: int) -> Dict[str, float]:
        seed = self.cfg.seed * 100003 + epoch
        generator = self._generator(seed)
        batches = prefetch_to_device(
            map(self._block, self.datamodule.batches("train", shuffle=self.reshuffle,
                                                     seed=seed)),
            self.device, size=int(getattr(self.cfg, "prefetch", 2) or 2))
        total, count = {}, 0
        for batch in batches:
            _accumulate(total, self.train_step(batch, generator=generator))
            count += 1
        self.step += count
        return {f"train_{k}": v for k, v in _host_means(total, count).items()}

    def validate(self, epoch: int) -> Dict[str, float]:
        generator = self._generator(7 + epoch)
        total, count = {}, 0
        for batch in prefetch_to_device(map(self._block, self.datamodule.batches("val")),
                                        self.device):
            _accumulate(total, self.eval_step(batch, generator=generator))
            count += 1
        if count == 0:
            return {}
        return {f"val_{k}": v for k, v in _host_means(total, count).items()}

    # -- fit / test ------------------------------------------------------------------

    def fit(self, epochs: Optional[int] = None, log_fn=print) -> Dict[str, float]:
        """Train up to ``epochs`` (default ``cfg.epochs``), starting after the
        epochs the current step has done; validate, log, checkpoint ``last``
        (and ``best`` when the val loss improved) every ``ckpt_freq`` epochs
        and at the end.  Returns the last epoch's metrics."""
        if self.step is None:
            self.init_state()
        if self.rank:
            log_fn = None
        epochs = epochs or self.cfg.epochs
        history = {}
        scan = self.use_scan()
        ckpt_freq = int(getattr(self.cfg, "ckpt_freq", 1) or 1)
        steps_per_epoch = self.datamodule.steps_per_epoch()
        start_epoch = self.step // max(steps_per_epoch, 1)
        kernel_paths_logged = False
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            train_metrics = self.run_epoch_scan(epoch) if scan else self.run_epoch(epoch)
            val_metrics = self.validate_scan(epoch) if scan else self.validate(epoch)
            elapsed = time.perf_counter() - t0
            metrics = {**train_metrics, **val_metrics, "epoch_time_s": elapsed,
                       "samples_per_s": steps_per_epoch * self.cfg.batch_size
                       / max(elapsed, 1e-9)}
            self._log(epoch, metrics)
            if not kernel_paths_logged:
                # which kernels the epoch went through (cuda) or their plain
                # versions (plain), beside the epoch's numbers
                paths = telemetry.summary()
                if log_fn and paths:
                    log_fn(f"[kernels] dispatch: {paths}")
                kernel_paths_logged = True
            if log_fn:
                msg = " ".join(f"{k}={v:.4g}" for k, v in metrics.items()
                               if k in ("train_loss", "val_loss", "epoch_time_s",
                                        "samples_per_s"))
                log_fn(f"epoch {epoch}: {msg}")
            if self.cfg.mPath and ((epoch + 1) % ckpt_freq == 0 or epoch + 1 == epochs):
                # update the watermark before writing "last", so that the
                # checkpointed best_val reflects this epoch
                val_loss = val_metrics.get("val_loss", float("inf"))
                improved = val_loss < self.best_val
                if improved:
                    self.best_val = val_loss
                self.save_checkpoint("last")
                if improved:
                    self.save_checkpoint("best")
            if (self.enable_viz and self.cfg.mPath and self.rank == 0
                    and (epoch + 1) % max(int(self.cfg.viz_freq), 1) == 0):
                try:
                    self.run_visualizations(epoch)
                except Exception as e:  # a plot must never end training
                    if log_fn:
                        log_fn(f"[viz] skipped: {type(e).__name__}: {e}")
            history = metrics
        if self._tb is not None:
            self._tb.flush()
        return history

    def test(self) -> Dict[str, float]:
        """Validation at training end, then the dataset's own benchmark where
        it has one (reference trainer.py:171-178).  A benchmark that raises
        is reported, with its traceback on stderr, as ``stats["eval_error"]``.
        Every rank validates; rank 0 alone runs the benchmark."""
        stats = self.validate(epoch=10 ** 6)
        fn = self.datamodule.datasets[0].eval_statistics_fn()
        if fn is not None and self.rank == 0:
            try:
                stats.update(fn(self))
            except Exception as e:  # the trained run and its stats stay
                traceback.print_exc()
                stats["eval_error"] = f"{type(e).__name__}: {e}"
        return stats

    def run_visualizations(self, epoch: int) -> None:
        from multimodal_vae_comparison_tpu_torch import visualization
        visualization.epoch_visualizations(self, epoch)
