"""Cross-modal latent analysis: CCA between per-modality posteriors
(counterpart of ``eval/cca.py``).

The reference fits ``sklearn.cross_decomposition.CCA``, which the chip
machine does not have; :class:`CCA` is the same algorithm in numpy and
scipy: the data centred and scaled (ddof 1), then for each component the
first singular vectors of X'Y by the NIPALS power method in mode B (the
pseudo-inverses of the deflated X and Y), their signs flipped to make the
largest |x weight| positive, and canonical deflation of both sides; the
rotations are ``W (P' W)^+``.  ``max_iter`` and ``tol`` are sklearn's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _pinv2_old(a: np.ndarray) -> np.ndarray:
    """The pseudo-inverse with the rank cut of scipy's old ``pinv2`` (the
    condition 1e6 eps of float64 times the largest singular value)."""
    from scipy.linalg import svd
    u, s, vh = svd(a, full_matrices=False, check_finite=False)
    cond = np.max(s) * 1e6 * np.finfo(np.float64).eps
    rank = int(np.sum(s > cond))
    u = u[:, :rank] / s[:rank]
    return np.transpose(np.dot(u, vh[:rank]))


def _first_singular_vectors(X, y, max_iter: int, tol: float):
    eps = np.finfo(X.dtype).eps
    try:
        y_score = next(col for col in y.T if np.any(np.abs(col) > eps))
    except StopIteration as e:
        raise StopIteration("y residual is constant") from e
    x_weights_old = 100
    X_pinv, y_pinv = _pinv2_old(X), _pinv2_old(y)
    for _ in range(max_iter):
        x_weights = np.dot(X_pinv, y_score)
        x_weights /= np.sqrt(np.dot(x_weights, x_weights)) + eps
        x_score = np.dot(X, x_weights)
        y_weights = np.dot(y_pinv, x_score)
        y_weights /= np.sqrt(np.dot(y_weights, y_weights)) + eps
        y_score = np.dot(y, y_weights) / (np.dot(y_weights, y_weights) + eps)
        diff = x_weights - x_weights_old
        if np.dot(diff, diff) < tol or y.shape[1] == 1:
            break
        x_weights_old = x_weights
    return x_weights, y_weights


class CCA:
    """Canonical correlation analysis, as ``sklearn.cross_decomposition.CCA``
    (``scale=True``, NIPALS) computes it."""

    def __init__(self, n_components: int = 2, max_iter: int = 500, tol: float = 1e-06):
        self.n_components, self.max_iter, self.tol = n_components, max_iter, tol

    def fit(self, X, y) -> "CCA":
        from scipy.linalg import pinv
        X = np.array(X, dtype=np.float64)
        y = np.array(y, dtype=np.float64)
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        n, p, q, k_max = X.shape[0], X.shape[1], y.shape[1], self.n_components
        if k_max > min(n, p, q):
            raise ValueError(f"`n_components` upper bound is {min(n, p, q)}. "
                             f"Got {k_max} instead. Reduce `n_components`.")
        self.x_mean, self.y_mean = X.mean(axis=0), y.mean(axis=0)
        X -= self.x_mean
        y -= self.y_mean
        self.x_std, self.y_std = X.std(axis=0, ddof=1), y.std(axis=0, ddof=1)
        self.x_std[self.x_std == 0.0] = 1.0
        self.y_std[self.y_std == 0.0] = 1.0
        X /= self.x_std
        y /= self.y_std
        x_w, y_w = np.zeros((p, k_max)), np.zeros((q, k_max))
        x_l, y_l = np.zeros((p, k_max)), np.zeros((q, k_max))
        y_eps = np.finfo(y.dtype).eps
        for k in range(k_max):
            y[:, np.all(np.abs(y) < 10 * y_eps, axis=0)] = 0.0
            try:
                xw, yw = _first_singular_vectors(X, y, self.max_iter, self.tol)
            except StopIteration as e:
                if str(e) != "y residual is constant":
                    raise
                break
            sign = np.sign(xw[np.argmax(np.abs(xw))])
            xw *= sign
            yw *= sign
            x_scores = np.dot(X, xw)
            y_scores = np.dot(y, yw)
            xl = np.dot(x_scores, X) / np.dot(x_scores, x_scores)
            X -= np.outer(x_scores, xl)
            yl = np.dot(y_scores, y) / np.dot(y_scores, y_scores)
            y -= np.outer(y_scores, yl)
            x_w[:, k], y_w[:, k], x_l[:, k], y_l[:, k] = xw, yw, xl, yl
        self.x_rotations = np.dot(x_w, pinv(np.dot(x_l.T, x_w), check_finite=False))
        self.y_rotations = np.dot(y_w, pinv(np.dot(y_l.T, y_w), check_finite=False))
        return self

    def transform(self, X, y) -> Tuple[np.ndarray, np.ndarray]:
        """Both sides' scores; a float32 input is scaled in float32, as
        sklearn's ``transform`` keeps its dtype."""
        X = np.array(X, dtype=np.result_type(np.asarray(X).dtype, np.float32))
        y = np.array(y, dtype=np.result_type(np.asarray(y).dtype, np.float32))
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        X -= self.x_mean
        X /= self.x_std
        y -= self.y_mean
        y /= self.y_std
        return np.dot(X, self.x_rotations), np.dot(y, self.y_rotations)

    def fit_transform(self, X, y) -> Tuple[np.ndarray, np.ndarray]:
        return self.fit(X, y).transform(X, y)


def latent_cca_correlation(exp, n: int = 1000, n_components: int = 4) -> Dict[str, float]:
    """Mean canonical correlation between each pair of modality posteriors."""
    batch, _ = exp.get_test_samples(min(n, exp.datamod.n_val))
    out = exp.forward({m: batch[m] for m in exp.mod_names}, present=tuple(exp.mod_names))
    latents = {}
    for name in exp.mod_names:
        q = out.mods[name].encoder_dist or out.mods[name].joint_dist
        latents[name] = q.loc.detach().cpu().numpy()
    results = {}
    names = list(latents)
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            a, b = latents[names[i]], latents[names[j]]
            k = min(n_components, a.shape[1], b.shape[1])
            xa, xb = CCA(n_components=k, max_iter=1000).fit_transform(a, b)
            corrs = [np.corrcoef(xa[:, c], xb[:, c])[0, 1] for c in range(k)]
            results[f"cca_{names[i]}_{names[j]}"] = float(np.mean(corrs))
    return results
