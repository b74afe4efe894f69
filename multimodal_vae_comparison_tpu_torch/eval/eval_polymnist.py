"""PolyMNIST benchmark: 5-modality conditional and joint digit coherence
(counterpart of ``eval/eval_polymnist.py``).

The reference ships the PolyMNIST dataset without an eval script; the JAX
package implements the published protocol of the dataset (MoPoE paper,
https://arxiv.org/abs/2105.02470 §5.2), and so does the port:

* cross coherence: m_j generated from m_i alone for each of the 20 ordered
  pairs, the digit read by a judge trained on m_j, and their mean;
* joint coherence: prior samples decoded by all five decoders, the judged
  digits must agree;
* latent accuracy: a linear probe of the joint posterior;
* the judges' mean accuracy on real val images, beside the judged stats.

The judges, probe and coherences are MNIST-SVHN's (``eval_mnistsvhn.py``);
the judges cache as ``polymnist_digit_<mod>_v2.pt`` under
``eval/classifiers/`` (``POLYMNIST_CLASSIFIER_DIR`` overrides it).  The
stats are fractions; ``<run>/polymnist_stats.txt`` holds them as
percentages.

    MultimodalVAEInfer(<run dir>).eval_statistics()    # or Trainer.test()
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from multimodal_vae_comparison_tpu_torch.eval.classifiers import (
    CLASSIFIER_DIR, digit_classifiers, judge_calibration)
from multimodal_vae_comparison_tpu_torch.eval.eval_mnistsvhn import (
    cross_coherence, joint_coherence, latent_digit_accuracy)


def polymnist_stats(exp) -> Dict[str, float]:
    """The 24 stats of one run (a MultimodalVAEInfer at K = 1) as fractions,
    written to ``<run>/polymnist_stats.txt`` as percentages: the latent
    accuracy, the judges' mean accuracy on at most 500 real val rows, the
    mean of the 20 cross coherences (over 500 rows) and each of them, and
    the joint coherence (500 samples)."""
    from multimodal_vae_comparison_tpu_torch.utils import print_save_stats
    judges = digit_classifiers(exp, os.environ.get("POLYMNIST_CLASSIFIER_DIR", CLASSIFIER_DIR),
                               prefix="polymnist")
    stats = {"latent_accuracy": latent_digit_accuracy(exp)}
    batch, labels = exp.get_test_samples(min(500, exp.datamod.n_val))
    y = np.asarray(labels[: len(batch[exp.mod_names[0]]["data"])])
    stats["judge_accuracy_real_mean"] = float(np.mean([
        judge_calibration(judges[name], np.asarray(batch[name]["data"]), y,
                          name=f"polymnist_{name}") for name in exp.mod_names]))
    pairwise = cross_coherence(exp, judges, n=500)
    stats["cross_coherence_mean"] = float(np.mean(list(pairwise.values())))
    stats.update(pairwise)
    stats["joint_coherence"] = joint_coherence(exp, judges, n=500)
    run_dir = getattr(exp, "run_dir", None) or exp.config.mPath
    if run_dir:
        print_save_stats({k: {"value": 100 * v, "stdev": None} for k, v in stats.items()},
                         run_dir, "polymnist")
    return stats


def polymnist_eval(trainer_or_infer) -> Dict[str, float]:
    """The dataset's benchmark hook (``POLYMNIST.eval_statistics_fn``):
    :func:`polymnist_stats` on a MultimodalVAEInfer or a live Trainer."""
    from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import _as_infer
    with _as_infer(trainer_or_infer) as exp:
        return polymnist_stats(exp)
