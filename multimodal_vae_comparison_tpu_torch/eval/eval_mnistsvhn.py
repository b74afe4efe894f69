"""MNIST-SVHN benchmark (counterpart of ``eval/eval_mnistsvhn.py``): for
now only its latent probe, :func:`latent_digit_accuracy`, which the
FashionMNIST benchmark shares.  The rest of the MNIST-SVHN benchmark
(cross and joint coherence on digit judges) comes with its dataset, ROADMAP
Queue A item 7d.

The probe's logistic regression is the sklearn-free fit of
``eval/vilanro_probe.py`` at sklearn's ``LogisticRegression`` defaults (C
1) and the reference's ``max_iter`` 500: the machine with the card has no
sklearn.
"""
from __future__ import annotations

import numpy as np

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
