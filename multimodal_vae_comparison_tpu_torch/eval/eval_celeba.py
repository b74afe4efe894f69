"""CelebA benchmark: attribute <-> image coherence (counterpart of
``eval/eval_celeba.py``).

The reference trains CelebA but ships no eval for it; the JAX package
applies the framework's judge-then-agree protocol to the 4 binary
attributes (bald, eyeglasses, male, smiling), and so does the port:

* atts -> image: a 4-head CNN judge reads the generated face's attributes;
* image -> atts: the arg-max of the generated attribute one-hots;
* joint: prior samples decoded by both decoders must agree.

The judge is trained on the run's train split at first use and cached as
``celeba_att_clf_v2.pt`` under ``eval/classifiers/``
(``CELEBA_CLASSIFIER_DIR`` overrides it).  The stats are fractions; the
stats file ``<run>/celeba_stats.txt`` holds them as percentages.

    MultimodalVAEInfer(<run dir>).eval_statistics()    # or Trainer.test()
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from multimodal_vae_comparison_tpu_torch.eval.classifiers import (
    CLASSIFIER_DIR, CNNClassifier, get_or_train_classifier, mods_by_type, predict)

# the stats of celeba_eval, in the order of the stats file
STATS_KEYS = ("judge_accuracy_real", "atts_to_image_strict", "atts_to_image_mean",
              "image_to_atts_strict", "image_to_atts_mean", "joint_coherence")


def _att_judge(exp, mapping, cache_dir: str):
    """The 4-head attribute judge, 2 classes a head: 8 epochs at lr 1e-3 on
    the TRAIN split only (the calibration scores the val split)."""
    img_idx = exp.mod_names.index(mapping["image"])
    att_idx = exp.mod_names.index(mapping["atts"])

    def data_fn():
        imgs, _ = exp.datamod.split_arrays(img_idx, "train")
        atts, _ = exp.datamod.split_arrays(att_idx, "train")
        return imgs.astype(np.float32), np.argmax(atts, -1)

    return get_or_train_classifier(os.path.join(cache_dir, "celeba_att_clf_v2.pt"),
                                   CNNClassifier(num_classes=2, heads=4).to(exp.device),
                                   data_fn, epochs=8)


def celeba_stats(exp) -> Dict[str, float]:
    """The 6 stats of one run (a MultimodalVAEInfer at K = 1) over at most
    500 val rows, as fractions, written to ``<run>/celeba_stats.txt`` as
    percentages."""
    from multimodal_vae_comparison_tpu_torch.utils import print_save_stats
    mapping = mods_by_type(exp)
    judge = _att_judge(exp, mapping,
                       os.environ.get("CELEBA_CLASSIFIER_DIR", CLASSIFIER_DIR))
    n = min(500, exp.datamod.n_val)
    batch, _ = exp.get_test_samples(n)
    images, atts = batch[mapping["image"]]["data"], batch[mapping["atts"]]["data"]
    atts_gt = np.argmax(np.asarray(atts), -1)
    stats = {}
    # the judge's accuracy on held-out REAL images bounds the judged stats
    stats["judge_accuracy_real"] = float((predict(judge, np.asarray(images)) == atts_gt).mean())
    print(f"[judge] celeba_judge_accuracy_real: {100 * stats['judge_accuracy_real']:.1f}%")
    pred = predict(judge, exp.cross_generate(mapping["atts"], atts)[mapping["image"]])
    stats["atts_to_image_strict"] = float((pred == atts_gt).all(-1).mean())
    stats["atts_to_image_mean"] = float((pred == atts_gt).mean())
    pred_atts = np.argmax(exp.cross_generate(mapping["image"], images)[mapping["atts"]], -1)
    stats["image_to_atts_strict"] = float((pred_atts == atts_gt).all(-1).mean())
    stats["image_to_atts_mean"] = float((pred_atts == atts_gt).mean())
    joint = exp.joint_generate(min(n, 256))
    stats["joint_coherence"] = float((predict(judge, joint[mapping["image"]])
                                      == np.argmax(joint[mapping["atts"]], -1)).mean())
    run_dir = getattr(exp, "run_dir", None) or exp.config.mPath
    if run_dir:
        print_save_stats({k: {"value": 100 * v, "stdev": None} for k, v in stats.items()},
                         run_dir, "celeba")
    return stats


def celeba_eval(trainer_or_infer) -> Dict[str, float]:
    """The dataset's benchmark hook (``CELEBA.eval_statistics_fn``):
    :func:`celeba_stats` on a MultimodalVAEInfer or a live Trainer."""
    from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import _as_infer
    with _as_infer(trainer_or_infer) as exp:
        return celeba_stats(exp)
