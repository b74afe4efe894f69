"""FashionMNIST benchmark: label <-> image coherence and a latent probe
(counterpart of ``eval/eval_fashionmnist.py``).

The reference trains FashionMNIST without an eval of its own; the JAX
package applies the judge-then-agree protocol with a 10-class garment
judge, and so does the port:

* latent: a linear probe from the joint posterior's means to the class
  (:func:`eval_mnistsvhn.latent_digit_accuracy`);
* label -> image: the judge reads the generated garment's class;
* image -> label: the arg-max of the generated label one-hot;
* joint: prior samples decoded by both decoders must agree.

The judge (``CNNClassifier`` on 28x28x1, 6 epochs) is trained on the run's
train split at first use and cached as ``fashionmnist_clf_v2.pt`` under
``eval/classifiers/`` (``FASHIONMNIST_CLASSIFIER_DIR`` overrides it).  The
stats are fractions; ``<run>/fashionmnist_stats.txt`` holds them as
percentages.

    MultimodalVAEInfer(<run dir>).eval_statistics()    # or Trainer.test()
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from multimodal_vae_comparison_tpu_torch.eval.classifiers import (
    CLASSIFIER_DIR, CNNClassifier, get_or_train_classifier, judge_calibration, mods_by_type,
    predict)
from multimodal_vae_comparison_tpu_torch.eval.eval_mnistsvhn import latent_digit_accuracy

# the stats of fashionmnist_stats, in the order of the stats file
STATS_KEYS = ("latent_accuracy", "judge_accuracy_real", "label_to_image", "image_to_label",
              "joint_coherence")


def _garment_judge(exp, mapping, cache_dir: str):
    """The 10-class judge: 6 epochs on the TRAIN split only (the
    calibration scores the val split)."""
    img_idx = exp.mod_names.index(mapping["image"])

    def data_fn():
        imgs, _ = exp.datamod.split_arrays(img_idx, "train")
        return imgs.astype(np.float32), np.asarray(exp.datamod.labels_train)

    judge = CNNClassifier(num_classes=10,
                          in_shape=tuple(exp.config.mods[img_idx].feature_dims))
    return get_or_train_classifier(os.path.join(cache_dir, "fashionmnist_clf_v2.pt"),
                                   judge.to(exp.device), data_fn, epochs=6)


def fashionmnist_stats(exp) -> Dict[str, float]:
    """The 5 stats of one run (a MultimodalVAEInfer at K = 1) over at most
    500 val rows, as fractions, written to ``<run>/fashionmnist_stats.txt``
    as percentages."""
    from multimodal_vae_comparison_tpu_torch.utils import print_save_stats
    mapping = mods_by_type(exp)
    judge = _garment_judge(exp, mapping,
                           os.environ.get("FASHIONMNIST_CLASSIFIER_DIR", CLASSIFIER_DIR))
    n = min(500, exp.datamod.n_val)
    batch, _ = exp.get_test_samples(n)
    images, labels = batch[mapping["image"]]["data"], batch[mapping["label"]]["data"]
    y = np.argmax(np.asarray(labels), -1)
    stats = {"latent_accuracy": latent_digit_accuracy(exp)}
    # the judge's accuracy on held-out REAL images bounds the judged stats
    stats["judge_accuracy_real"] = judge_calibration(judge, np.asarray(images), y,
                                                     name="fashionmnist")
    pred = predict(judge, exp.cross_generate(mapping["label"], labels)[mapping["image"]])
    stats["label_to_image"] = float((pred == y).mean())
    recons = exp.cross_generate(mapping["image"], images)
    stats["image_to_label"] = float((np.argmax(recons[mapping["label"]], -1) == y).mean())
    joint = exp.joint_generate(min(n, 256))
    stats["joint_coherence"] = float((predict(judge, joint[mapping["image"]])
                                      == np.argmax(joint[mapping["label"]], -1)).mean())
    run_dir = getattr(exp, "run_dir", None) or exp.config.mPath
    if run_dir:
        print_save_stats({k: {"value": 100 * v, "stdev": None} for k, v in stats.items()},
                         run_dir, "fashionmnist")
    return stats


def fashionmnist_eval(trainer_or_infer) -> Dict[str, float]:
    """The dataset's benchmark hook (``FASHIONMNIST.eval_statistics_fn``):
    :func:`fashionmnist_stats` on a MultimodalVAEInfer or a live Trainer."""
    from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import _as_infer
    with _as_infer(trainer_or_infer) as exp:
        return fashionmnist_stats(exp)
