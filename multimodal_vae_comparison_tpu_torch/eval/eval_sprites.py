"""SPRITES benchmark: cross- and joint-coherence judged by video and
attribute classifiers (counterpart of ``eval/eval_sprites.py``).

The reference's four cross directions (frames->actions, actions->frames,
frames->attributes, attributes->frames), its two joint agreements of
prior samples (action-frame and attribute-frame) and its per-feature
labelled t-SNE, judged by two classifiers trained on the run's train split
at first use and cached under ``eval/classifiers/``
(``SPRITES_CLASSIFIER_DIR`` overrides it): the motion-aware
``ActionVideoClassifier`` (``sprites_action_clf_v3.pt``) and the
frame-0 ``FrameAttributeClassifier`` over the 4 attributes
(``sprites_att_clf_v4.pt``).  ``SPRITES_EVAL_SAMPLES`` test rows are scored
(500, at most the val split's size).  The stats are fractions; the stats
file ``<run>/sprites_stats.txt`` holds them as percentages.

    MultimodalVAEInfer(<run dir>).eval_statistics()    # or Trainer.test()
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from multimodal_vae_comparison_tpu_torch.eval.classifiers import (
    CLASSIFIER_DIR, ActionVideoClassifier, FrameAttributeClassifier,
    get_or_train_classifier, mods_by_type, predict)

# the stats of sprites_eval, in the order of the stats file
STATS_KEYS = ("att_judge_accuracy_real", "action_judge_accuracy_real", "actions_to_frames",
              "atts_to_frames", "atts_to_frames_mean", "frames_to_actions", "frames_to_atts",
              "frames_to_atts_mean", "joint_coherence", "joint_att_frame")


def _frames_train_data(exp, mapping) -> np.ndarray:
    # the TRAIN split only: the judges' calibration scores held-out rows
    frames, _ = exp.datamod.split_arrays(exp.mod_names.index(mapping["frames"]), "train")
    return frames.astype(np.float32)


def _frames_shape(exp, mapping):
    return tuple(exp.config.mods[exp.mod_names.index(mapping["frames"])].feature_dims)


def _action_classifier(exp, cache_dir: str):
    """The motion-aware action judge (temporal differences, a
    spatiotemporal flatten): 30 epochs at lr 3e-4 on the train split."""
    mapping = mods_by_type(exp)
    model = ActionVideoClassifier(num_classes=9, in_shape=_frames_shape(exp, mapping))

    def data_fn():
        actions, _ = exp.datamod.split_arrays(exp.mod_names.index(mapping["actions"]), "train")
        return _frames_train_data(exp, mapping), np.argmax(actions, -1)

    return get_or_train_classifier(os.path.join(cache_dir, "sprites_action_clf_v3.pt"),
                                   model.to(exp.device), data_fn, epochs=30, lr=3e-4)


def _attribute_classifier(exp, cache_dir: str):
    """The 4-head judge over (skin, pants, top, hair), 6 classes each, on
    frame 0 with a spatial flatten: 40 epochs at lr 3e-4 on the train
    split (the reference's frame2attributes role)."""
    mapping = mods_by_type(exp)
    model = FrameAttributeClassifier(num_classes=6, heads=4,
                                     in_shape=_frames_shape(exp, mapping)[1:])

    def data_fn():
        atts, _ = exp.datamod.split_arrays(exp.mod_names.index(mapping["attributes"]), "train")
        return _frames_train_data(exp, mapping), np.argmax(atts, -1)   # (N, 4) targets

    return get_or_train_classifier(os.path.join(cache_dir, "sprites_att_clf_v4.pt"),
                                   model.to(exp.device), data_fn, epochs=40, lr=3e-4)


def labelled_tsne(exp, n: int = 250) -> None:
    """Per-feature labelled t-SNE of each modality's latents over ``n``
    test rows (reference eval_sprites.py:147-161): one plot per label
    family, the 9 action/direction combinations and each of the 4
    attributes, as ``<run>/visuals/eval_tsne_{mod}_{family}.png``.
    matplotlib and sklearn are imported here; without sklearn nothing is
    drawn."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from multimodal_vae_comparison_tpu_torch.data.datasets import SPRITES

    mapping = mods_by_type(exp)
    batch, _ = exp.get_test_samples(n)
    out = exp.forward(batch, present=tuple(exp.mod_names))
    actions = np.argmax(np.asarray(batch[mapping["actions"]]["data"]), -1)
    atts = np.argmax(np.asarray(batch[mapping["attributes"]]["data"]), -1)
    label_sets = [("action", [SPRITES.label_map[a] for a in actions])]
    for i, att_name in enumerate(SPRITES.attr_map):
        label_sets.append((att_name, [f"{att_name}_{v}" for v in atts[:, i]]))
    vis_dir = os.path.join(getattr(exp, "run_dir", None) or exp.config.mPath, "visuals")
    os.makedirs(vis_dir, exist_ok=True)
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        return
    for nm in exp.mod_names:
        mo = out.mods[nm]
        if mo.latents is None:
            continue
        z = mo.latents[0].cpu().numpy()
        emb = TSNE(n_components=2, init="pca",
                   perplexity=min(30, max(2, len(z) // 4))).fit_transform(z)
        for fam, labs in label_sets:
            fig, ax = plt.subplots(figsize=(6, 6))
            for u in sorted(set(labs)):
                m = [i for i, lab in enumerate(labs) if lab == u]
                ax.scatter(emb[m, 0], emb[m, 1], s=8, label=u)
            ax.legend(fontsize=5, markerscale=0.6)
            fig.savefig(os.path.join(vis_dir, f"eval_tsne_{nm}_{fam}.png"), dpi=120)
            plt.close(fig)


def sprites_stats(exp) -> Dict[str, float]:
    """The 10 stats of one run (a MultimodalVAEInfer at K = 1), as
    fractions, written to ``<run>/sprites_stats.txt`` as percentages."""
    from multimodal_vae_comparison_tpu_torch.utils import print_save_stats
    mapping = mods_by_type(exp)
    cache_dir = os.environ.get("SPRITES_CLASSIFIER_DIR", CLASSIFIER_DIR)
    act_judge = _action_classifier(exp, cache_dir)
    att_judge = _attribute_classifier(exp, cache_dir)
    n = min(int(os.environ.get("SPRITES_EVAL_SAMPLES", 500)), exp.datamod.n_val)
    batch, _ = exp.get_test_samples(n)
    frames, actions, atts = (batch[mapping[k]]["data"]
                             for k in ("frames", "actions", "attributes"))
    actions_gt, atts_gt = np.argmax(actions, -1), np.argmax(atts, -1)
    stats = {}
    # the judges' own accuracy on REAL frames bounds every judged stat below
    stats["att_judge_accuracy_real"] = float((predict(att_judge, frames) == atts_gt).mean())
    print(f"[judge] sprites_att_judge_accuracy_real: "
          f"{100 * stats['att_judge_accuracy_real']:.1f}%")
    stats["action_judge_accuracy_real"] = float(
        (predict(act_judge, frames) == actions_gt).mean())
    print(f"[judge] sprites_action_judge_accuracy_real: "
          f"{100 * stats['action_judge_accuracy_real']:.1f}%")
    # actions -> frames: the action judge on the generated clips
    recons = exp.cross_generate(mapping["actions"], actions)
    stats["actions_to_frames"] = float(
        (predict(act_judge, recons[mapping["frames"]]) == actions_gt).mean())
    # attributes -> frames: all 4 right, and the per-attribute mean
    recons = exp.cross_generate(mapping["attributes"], atts)
    pred = predict(att_judge, recons[mapping["frames"]])
    stats["atts_to_frames"] = float((pred == atts_gt).all(-1).mean())
    stats["atts_to_frames_mean"] = float((pred == atts_gt).mean())
    # frames -> actions and frames -> attributes: arg-max of the generated one-hots
    recons = exp.cross_generate(mapping["frames"], frames)
    stats["frames_to_actions"] = float(
        (np.argmax(recons[mapping["actions"]], -1) == actions_gt).mean())
    pred_atts = np.argmax(recons[mapping["attributes"]], -1)
    stats["frames_to_atts"] = float((pred_atts == atts_gt).all(-1).mean())
    stats["frames_to_atts_mean"] = float((pred_atts == atts_gt).mean())
    # joint coherence: do prior-sampled clips agree with the sampled
    # actions and attributes?
    joint = exp.joint_generate(min(n, 256))
    stats["joint_coherence"] = float((predict(act_judge, joint[mapping["frames"]])
                                      == np.argmax(joint[mapping["actions"]], -1)).mean())
    stats["joint_att_frame"] = float((predict(att_judge, joint[mapping["frames"]])
                                      == np.argmax(joint[mapping["attributes"]], -1)).mean())
    try:
        labelled_tsne(exp)
    except Exception as e:  # a plot never fails the benchmark
        print(f"[viz] labelled t-SNE skipped: {type(e).__name__}: {e}")
    run_dir = getattr(exp, "run_dir", None) or exp.config.mPath
    if run_dir:
        print_save_stats({k: {"value": 100 * v, "stdev": None} for k, v in stats.items()},
                         run_dir, "sprites")
    return stats


def sprites_eval(trainer_or_infer) -> Dict[str, float]:
    """The dataset's benchmark hook (``SPRITES.eval_statistics_fn``):
    :func:`sprites_stats` on a MultimodalVAEInfer or a live Trainer."""
    from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import _as_infer
    with _as_infer(trainer_or_infer) as exp:
        return sprites_stats(exp)
