"""MNIST-SVHN benchmark: latent digit classification and cross / joint
coherence (counterpart of ``eval/eval_mnistsvhn.py``).

* latent accuracy: a linear probe from the joint posterior's means (each
  modality's own where the model has none) to the digit;
* cross coherence: SVHN generated from MNIST and MNIST from SVHN, the
  digit read by a judge trained on the target modality;
* joint coherence: prior samples decoded by both decoders, the judged
  digits must agree.

The judges (``CNNClassifier`` per modality, 6 epochs) are trained on the
run's train split at first use (``classifiers.digit_classifiers``) and
cached as ``mnistsvhn_digit_<mod>_v2.pt`` under ``eval/classifiers/``
(``MNISTSVHN_CLASSIFIER_DIR`` overrides it); each judge's accuracy on real
val images stands beside the judged stats.  The stats are fractions;
``<run>/mnist_svhn_stats.txt`` holds them as percentages.  PolyMNIST's
benchmark (``eval_polymnist.py``) shares the probe and both coherences.

The probe's logistic regression is the sklearn-free fit of
``eval/vilanro_probe.py`` at sklearn's ``LogisticRegression`` defaults (C
1) and the reference's ``max_iter`` 500: the machine with the card has no
sklearn.

    MultimodalVAEInfer(<run dir>).eval_statistics()    # or Trainer.test()
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from multimodal_vae_comparison_tpu_torch.eval.classifiers import (
    CLASSIFIER_DIR, digit_classifiers, judge_calibration, predict)
from multimodal_vae_comparison_tpu_torch.eval.vilanro_probe import logreg_fit, logreg_predict

# the reference's LogisticRegression(max_iter=500)
PROBE_MAX_ITER = 500


def latent_digit_accuracy(exp, n: int = 2000) -> float:
    """Held-out accuracy of a linear probe from the joint posterior's means
    (each modality's own where the model has no joint) to the class labels,
    over at most ``n`` rows of the test split (the val split without one):
    the rows shuffled with ``default_rng(0)``, fitted on the first 80 %."""
    batch, labels = exp.get_test_samples(min(n, exp.datamod.n_val))
    out = exp.forward({m: batch[m] for m in exp.mod_names}, present=tuple(exp.mod_names))
    first = out.mods[exp.mod_names[0]]
    q = first.joint_dist if first.joint_dist is not None else first.encoder_dist
    z = q.loc.detach().cpu().numpy()
    y = np.asarray(labels[: len(z)])
    # the rows may be class-ordered: shuffle before the 80/20 split
    perm = np.random.default_rng(0).permutation(len(z))
    z, y = z[perm], y[perm]
    n_train = int(0.8 * len(z))
    fit = logreg_fit(z[:n_train], y[:n_train], max_iter=PROBE_MAX_ITER)
    return float((logreg_predict(fit, z[n_train:]) == y[n_train:]).mean())


def cross_coherence(exp, judges, n: int = 1000) -> Dict[str, float]:
    """``{"<src>_to_<tgt>": share}`` over every ordered pair of modalities:
    the share of at most ``n`` test rows whose generation of ``tgt`` from
    ``src`` alone the judge of ``tgt`` reads as the row's digit."""
    batch, labels = exp.get_test_samples(min(n, exp.datamod.n_val))
    y = np.asarray(labels[: len(batch[exp.mod_names[0]]["data"])])
    accs = {}
    for src in exp.mod_names:
        recons = exp.cross_generate(src, batch[src]["data"])
        for tgt in exp.mod_names:
            if tgt != src:
                accs[f"{src}_to_{tgt}"] = float((predict(judges[tgt], recons[tgt]) == y).mean())
    return accs


def joint_coherence(exp, judges, n: int = 1000) -> float:
    """The mean over the other modalities of the share of ``n`` prior
    samples whose judged digit agrees with the first modality's."""
    recons = exp.joint_generate(n)
    preds = [predict(judges[name], recons[name]) for name in exp.mod_names]
    return float(np.mean([np.mean(preds[0] == p) for p in preds[1:]]))


def mnistsvhn_stats(exp) -> Dict[str, float]:
    """The 6 stats of one run (a MultimodalVAEInfer at K = 1) as fractions,
    written to ``<run>/mnist_svhn_stats.txt`` as percentages: the latent
    accuracy, each judge's accuracy on at most 500 real val rows, both
    cross coherences and the joint coherence."""
    from multimodal_vae_comparison_tpu_torch.utils import print_save_stats
    judges = digit_classifiers(exp, os.environ.get("MNISTSVHN_CLASSIFIER_DIR", CLASSIFIER_DIR),
                               prefix="mnistsvhn")
    stats = {"latent_accuracy": latent_digit_accuracy(exp)}
    batch, labels = exp.get_test_samples(min(500, exp.datamod.n_val))
    y = np.asarray(labels[: len(batch[exp.mod_names[0]]["data"])])
    for name in exp.mod_names:
        stats[f"{name}_judge_accuracy_real"] = judge_calibration(
            judges[name], np.asarray(batch[name]["data"]), y, name=f"mnistsvhn_{name}")
    stats.update(cross_coherence(exp, judges))
    stats["joint_coherence"] = joint_coherence(exp, judges)
    run_dir = getattr(exp, "run_dir", None) or exp.config.mPath
    if run_dir:
        print_save_stats({k: {"value": 100 * v, "stdev": None} for k, v in stats.items()},
                         run_dir, "mnist_svhn")
    return stats


def mnistsvhn_eval(trainer_or_infer) -> Dict[str, float]:
    """The dataset's benchmark hook (``MNIST_SVHN.eval_statistics_fn``):
    :func:`mnistsvhn_stats` on a MultimodalVAEInfer or a live Trainer."""
    from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import _as_infer
    with _as_infer(trainer_or_infer) as exp:
        return mnistsvhn_stats(exp)
