"""Epoch-end visualizations: reconstruction grids, traversals, t-SNE and
per-dimension KL plots (counterpart of ``visualization.py``).

The device makes the latents and reconstructions; everything else runs on
host numpy.  The files land under ``<run>/visuals/epoch_K/`` with the JAX
package's names; a video modality's reconstructions also go to an animated
GIF.  ``cv2``, ``imageio``, ``matplotlib`` and ``sklearn`` are imported in
the functions that use them; the t-SNE plot is skipped where ``sklearn`` is
missing or refuses a tiny split, and the Trainer logs and skips a
visualization that raises (so a missing ``imageio`` ends the epoch's
visualizations at the first GIF).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from multimodal_vae_comparison_tpu_torch.models.distributions import Normal
from multimodal_vae_comparison_tpu_torch.models.precision import widen

TRAVERSAL_RANGES = (6, 4, 2, 1)   # reference trainer.py:229


def turn_text2image(strings: List[str], img_size=(64, 192, 3)) -> np.ndarray:
    """Render strings onto white tiles (reference utils.py:500-510)."""
    import cv2
    out = []
    for s in strings:
        img = np.ones(img_size, dtype=np.uint8) * 255
        for i, line in enumerate([s[j:j + 28] for j in range(0, len(s), 28)][:4]):
            cv2.putText(img, line, (2, 12 + 14 * i), cv2.FONT_HERSHEY_SIMPLEX,
                        0.3, (0, 0, 0), 1, cv2.LINE_AA)
        out.append(img)
    return np.stack(out)


def _to_tiles(dataset, decoded, img_size) -> np.ndarray:
    """Modality output -> uint8 image tiles for grid assembly."""
    if isinstance(decoded, np.ndarray) and decoded.dtype == np.uint8:
        arr = decoded
        if arr.ndim == 5:   # video: take first frame
            arr = arr[:, 0]
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, -1)
        return arr
    return turn_text2image([str(x) for x in decoded], img_size)


def save_video_gif(frames_batch: np.ndarray, path: str) -> None:
    """A batch of clips (N, T, H, W, C) as one animated GIF, the clips side
    by side in each frame (reference GIF writer, datasets.py:601-614)."""
    import imageio
    frames_batch = np.asarray(frames_batch)
    if frames_batch.dtype != np.uint8:
        frames_batch = (np.clip(frames_batch, 0, 1) * 255).astype(np.uint8)
    frames = [np.hstack(list(frames_batch[:, t])) for t in range(frames_batch.shape[1])]
    imageio.mimsave(path, frames, duration=0.15)


def save_grid(rows: List[np.ndarray], path: str) -> None:
    import cv2
    h = max(r.shape[1] for r in rows)
    w = max(r.shape[2] for r in rows)
    canvas = []
    for r in rows:
        padded = np.ones((r.shape[0], h, w, 3), np.uint8) * 255
        padded[:, :r.shape[1], :r.shape[2]] = r
        canvas.append(np.hstack(list(padded)))
    grid = np.vstack(canvas)
    cv2.imwrite(path, cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))


def _on_device(batch, device):
    return {name: {k: None if v is None else torch.from_numpy(v).to(device)
                   for k, v in mod.items()}
            for name, mod in batch.items()}


@torch.inference_mode()
def _forward(trainer, batch, present, seed: int):
    model = trainer.model
    model.eval()
    generator = torch.Generator(device=model.device).manual_seed(seed)
    return model.forward(_on_device(batch, model.device), present, generator=generator)


@torch.inference_mode()
def _decode(model, name: str, z: torch.Tensor) -> np.ndarray:
    # a bf16 model's image means are bf16, which numpy has no type for
    return widen(model.decode_mod(name, z.to(model.device)).mean[0]).cpu().numpy()


def save_reconstructions(trainer, epoch_dir: str, n: int = 8) -> None:
    """The cross-generation matrix over the single-modality subsets and the
    full set (reference trainer.py:180-215)."""
    batch = next(trainer.datamodule.batches("val", batch_size=n, drop_remainder=False))
    names = trainer.model.mod_names
    for present in [(nme,) for nme in names] + [tuple(names)]:
        out = _forward(trainer, batch, present, seed=0)
        rows = []
        for i, nm in enumerate(names):
            ds = trainer.datamodule.datasets[i]
            mo = out.mods[nm]
            if mo.decoder_dist is None:
                continue
            recon = widen(mo.decoder_dist.mean[0]).cpu().numpy()
            decoded = ds.decode_output(recon, batch[nm].get("masks"))
            if isinstance(decoded, np.ndarray) and decoded.ndim == 5:
                save_video_gif(decoded[:4], os.path.join(epoch_dir, f"recon_video_{nm}.gif"))
            rows.append(_to_tiles(ds, decoded, ds.text2img_size))
            gt = ds.decode_output(batch[nm]["data"], batch[nm].get("masks"))
            rows.append(_to_tiles(ds, gt, ds.text2img_size))
        tag = "_".join(present)
        save_grid(rows, os.path.join(epoch_dir, f"recon_from_{tag}.png"))


def save_joint_samples(trainer, epoch_dir: str, n: int = 8) -> None:
    """Per-dimension latent traversals at four ranges and prior samples
    (reference trainer.py:217-239)."""
    model = trainer.model
    D = model.n_latents
    z_prior = torch.randn((1, n, D), generator=torch.Generator().manual_seed(1))
    for rng_val in TRAVERSAL_RANGES:
        # each row sweeps one latent dimension over the range
        grid = np.zeros((D, n, D), np.float32)
        sweep = np.linspace(-rng_val, rng_val, n)
        for d in range(D):
            grid[d, :, d] = sweep
        z = torch.from_numpy(grid.reshape(1, D * n, D))
        for i, nm in enumerate(model.mod_names):
            ds = trainer.datamodule.datasets[i]
            tiles = _to_tiles(ds, ds.decode_output(_decode(model, nm, z)), ds.text2img_size)
            save_grid([tiles[d * n:(d + 1) * n] for d in range(D)],
                      os.path.join(epoch_dir, f"traversals_{nm}_pm{rng_val}.png"))
    for i, nm in enumerate(model.mod_names):
        ds = trainer.datamodule.datasets[i]
        decoded = ds.decode_output(_decode(model, nm, z_prior))
        save_grid([_to_tiles(ds, decoded, ds.text2img_size)],
                  os.path.join(epoch_dir, f"joint_samples_{nm}.png"))


def analyse_data(trainer, epoch_dir: str, max_points: int = 512) -> None:
    """t-SNE of the latents and boxplots of the per-dimension KL to N(0, 1)
    (reference trainer.py:242-272, visualization.py:78-135)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dm = trainer.datamodule
    batch = next(dm.batches("val", batch_size=min(max_points, max(dm.n_val, 2)),
                            drop_remainder=False))
    out = _forward(trainer, batch, trainer.model.mod_names, seed=2)
    labels = dm.labels_val
    for nm in trainer.model.mod_names:
        mo = out.mods[nm]
        if mo.latents is None:
            continue
        z = mo.latents[0].cpu().numpy()
        try:
            from sklearn.manifold import TSNE
            # sklearn refuses a perplexity at or over a tiny split's size
            emb = TSNE(n_components=2, init="pca",
                       perplexity=min(30, max(2, len(z) // 4))).fit_transform(z)
        except (ImportError, ValueError):
            emb = None
        if emb is not None:
            fig, ax = plt.subplots(figsize=(6, 6))
            if labels is not None:
                labs = ["|".join(l) if isinstance(l, (list, tuple)) else str(l)
                        for l in labels[: len(z)]]
                for u in sorted(set(labs))[:20]:
                    m = [i for i, l in enumerate(labs) if l == u]
                    ax.scatter(emb[m, 0], emb[m, 1], s=8, label=u)
                ax.legend(fontsize=5, markerscale=0.6)
            else:
                ax.scatter(emb[:, 0], emb[:, 1], s=8)
            fig.savefig(os.path.join(epoch_dir, f"tsne_{nm}.png"), dpi=120)
            plt.close(fig)
        q = mo.encoder_dist or mo.joint_dist
        if q is not None:
            # as a Gaussian whatever the posterior's family, as the reference plots it
            kld = Normal(q.loc, q.scale).kl(Normal(torch.zeros_like(q.loc),
                                                   torch.ones_like(q.scale)))
            kld = kld.cpu().numpy()
            fig, ax = plt.subplots(figsize=(8, 4))
            ax.boxplot([kld[:, d] for d in range(kld.shape[1])])
            ax.set_xlabel("latent dim")
            ax.set_ylabel("KL(q||p)")
            fig.savefig(os.path.join(epoch_dir, f"kl_dims_{nm}.png"), dpi=120)
            plt.close(fig)


def epoch_visualizations(trainer, epoch: int) -> None:
    epoch_dir = os.path.join(trainer.cfg.get_vis_dir(), f"epoch_{epoch}")
    os.makedirs(epoch_dir, exist_ok=True)
    save_reconstructions(trainer, epoch_dir)
    save_joint_samples(trainer, epoch_dir)
    analyse_data(trainer, epoch_dir)
