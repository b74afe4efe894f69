"""VILANRO latent-grounding probes: localize *why* a trained trimodal model
misses in closed-loop, below the level of the success rate.

The reference evaluates VILANRO models only by replay success
(multimodal_compare/models/vilanro_test.py:277-346); when a model scores low
that number says nothing about which link failed — image encoding, language
grounding, or the multimodal fusion.  This module adds three diagnostics
(no reference counterpart; introduced during the round-3 failure analysis):

1. **Linear latent probes** (ridge / logistic on posterior means):
   - image-only z  -> all object positions     (does the encoder see geometry?)
   - language-only z -> goal color             (does the encoder read language?)
   - joint z       -> object positions         (does fusion preserve geometry?)
   - joint z       -> goal offset              (is the *task quantity* present?)
2. **Instruction-flip probe**: re-infer the action endpoint with the
   instruction rewritten to name the distractor; the endpoint displacement
   measures how much the language modality actually steers the plan.
3. **Endpoint-magnitude calibration**: predicted-endpoint norm vs true goal
   offset norm (regression-to-the-mean shrink) and their cosine alignment.

The port's copy fits both probes itself, with numpy and scipy (no
sklearn): ridge with an intercept in closed form and the R^2 averaged
uniformly over targets; multinomial logistic regression (binary for two
classes) with an L2 penalty at C = 1 and an unpenalised intercept, by
L-BFGS.  The model is restored on the card unless ``--device cpu`` is given.

    python -m multimodal_vae_comparison_tpu_torch.eval.vilanro_probe \
        --model results/vilanro_r3_way_p2c/version_0 --scenes 400
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import numpy as np

from multimodal_vae_comparison_tpu_torch.lanro.env import make


def modality_roles(exp) -> Dict[str, str]:
    """Map semantic roles -> modality names from the run config (the same
    resolution vilanro_test.infer_loop does)."""
    mapping = {m.mod_type: m.name for m in exp.config.mods}
    act_type = next((t for t in ("actions", "action_tokens",
                                 "action_waypoints") if t in mapping), None)
    roles = {
        "language": mapping.get("language"),
        "action": mapping.get(act_type) if act_type else None,
        "action_type": act_type,
        "image": mapping.get("front RGB") or mapping.get("image"),
    }
    assert roles["language"] and roles["action"] and roles["image"], (
        f"expected language/actions/front RGB modalities, got {mapping}")
    return roles


def instruction_encoder(exp, lang_mod: str):
    """One-hot + mask encoder over the run's frozen training vocab."""
    lang_idx = int(lang_mod.split("_")[1]) - 1
    vocab = exp.datamod.datasets[lang_idx].vocab
    max_len = exp.config.mods[lang_idx].feature_dims[0]

    def encode(instruction: str):
        words = [w for w in instruction.split(" ") if w in vocab]
        idx = np.zeros((max_len,), np.int64)
        mask = np.zeros((max_len,), bool)
        for i, w in enumerate(words[:max_len]):
            idx[i] = vocab.index(w)
            mask[i] = True
        return np.eye(len(vocab), dtype=np.float32)[idx], mask

    return encode


def collect_scenes(env_id: str, n: int, seed: int,
                   img_size: int = 64) -> Dict[str, np.ndarray]:
    """Reset n fresh scenes and record observations + ground truth."""
    imgs, instrs, flips = [], [], []
    obj_pos, goal_off, goal_color = [], [], []
    colors: List[str] = []
    for t in range(n):
        env = make(env_id, seed=seed + 7919 * t, img_size=img_size)
        obs = env.reset()
        goal = env.sim.objects[env.goal_idx]
        others = [o for i, o in enumerate(env.sim.objects)
                  if i != env.goal_idx]
        imgs.append(obs["rgb"].astype(np.float32) / 255.0)
        instrs.append(obs["instruction"])
        # rewrite the instruction to name a distractor (grounding probe)
        flip = obs["instruction"]
        if others:
            flip = (flip.replace(goal.color, others[0].color)
                        .replace(goal.shape, others[0].shape))
        flips.append(flip)
        obj_pos.append(np.concatenate([o.pos for o in env.sim.objects]))
        goal_off.append(np.asarray(goal.pos) - np.asarray(env.sim.ee))
        if goal.color not in colors:
            colors.append(goal.color)
        goal_color.append(colors.index(goal.color))
    return {
        "imgs": np.stack(imgs), "instrs": instrs, "flips": flips,
        "obj_pos": np.stack(obj_pos).astype(np.float32),
        "goal_off": np.stack(goal_off).astype(np.float32),
        "goal_color": np.asarray(goal_color),
    }


def _posterior_means(exp, roles, scenes, present: Tuple[str, ...],
                     instructions=None) -> np.ndarray:
    enc = instruction_encoder(exp, roles["language"])
    pairs = [enc(s) for s in (instructions or scenes["instrs"])]
    inputs = {
        roles["image"]: {"data": scenes["imgs"], "masks": None},
        roles["language"]: {
            "data": np.stack([p[0] for p in pairs]),
            "masks": np.stack([p[1] for p in pairs])},
    }
    out = exp.forward(inputs, present=present)
    return out.mods[roles["image"]].joint_dist.mean.cpu().numpy()


def _predicted_endpoints(exp, roles, scenes, instructions) -> np.ndarray:
    """Decode the action modality and return the planned EE endpoint.

    For waypoints the final waypoint IS the endpoint the evaluator executes
    (first-difference replay telescopes to it, vilanro_test.py); for per-step
    deltas / tokens the endpoint is the (decoded) delta sum."""
    enc = instruction_encoder(exp, roles["language"])
    pairs = [enc(s) for s in instructions]
    inputs = {
        roles["image"]: {"data": scenes["imgs"], "masks": None},
        roles["language"]: {
            "data": np.stack([p[0] for p in pairs]),
            "masks": np.stack([p[1] for p in pairs])},
    }
    out = exp.forward(inputs,
                      present=(roles["image"], roles["language"]))
    raw = out.mods[roles["action"]].decoder_dist.mean[0].cpu().numpy()
    if roles["action_type"] == "action_waypoints":
        return raw[:, -1, :3]
    if roles["action_type"] == "action_tokens":
        act_ds = exp.datamod.datasets[int(roles["action"].split("_")[1]) - 1]
        raw = act_ds.decode_output(raw)
    return raw[..., :3].sum(axis=1)


# the probes' fits: ridge at alpha 1; logistic regression at C 1 by L-BFGS,
# stopped as sklearn's LogisticRegression(max_iter=2000) stops
RIDGE_ALPHA, LOGREG_C, LOGREG_MAX_ITER, LOGREG_TOL = 1.0, 1.0, 2000, 1e-4


def _split(n: int, seed: int):
    """The probes' 80/20 train/test split: a permutation from ``seed``."""
    perm = np.random.default_rng(seed).permutation(n)
    cut = int(0.8 * n)
    return perm[:cut], perm[cut:]


def _centred(y: np.ndarray):
    """(y - its column means, the means), exactly 0 in a constant column
    (a float mean of equal values can miss them by an ulp)."""
    const = np.ptp(y, axis=0) == 0
    mean = np.where(const, y[0], y.mean(0))
    return np.where(const, 0.0, y - mean), mean


def ridge_fit(x: np.ndarray, y: np.ndarray):
    """Ridge regression with an unpenalised intercept, in closed form on the
    centred data: (w (d, k), b (k,)) for y (n, k).  A constant target gets
    w = 0 and b = the constant, exactly."""
    x = np.asarray(x, np.float64)
    yc, ym = _centred(np.asarray(y, np.float64))
    xm = x.mean(0)
    xc = x - xm
    w = np.linalg.solve(xc.T @ xc + RIDGE_ALPHA * np.eye(x.shape[1]), xc.T @ yc)
    return w, ym - xm @ w


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Coefficient of determination, averaged uniformly over the targets.
    A target constant over the rows scores 1 when predicted exactly, else
    0.  (The objects' heights are such targets: every object rests on the
    table.  sklearn's float32 path scores them by rounding noise, e.g. -8.)"""
    y_true = np.asarray(y_true, np.float64).reshape(len(y_true), -1)
    y_pred = np.asarray(y_pred, np.float64).reshape(len(y_pred), -1)
    num = ((y_true - y_pred) ** 2).sum(0)
    den = (_centred(y_true)[0] ** 2).sum(0)
    scores = np.ones(num.shape)
    valid = (num != 0) & (den != 0)
    scores[valid] = 1.0 - num[valid] / den[valid]
    scores[(num != 0) & (den == 0)] = 0.0
    return float(scores.mean())


def logreg_fit(x: np.ndarray, y: np.ndarray, max_iter: int = LOGREG_MAX_ITER):
    """L2-penalised logistic regression by L-BFGS from zeros, on the mean
    log-loss plus 1/(2Cn)·|W|² (the intercept unpenalised): multinomial over
    the classes of ``y``, or one weight vector for two classes.  The
    objective's scale, the start and the stopping rule (gradient tolerance
    LOGREG_TOL, 50 line-search steps) are sklearn's ``LogisticRegression``
    defaults, so that its early stop lands where sklearn's does; at most
    ``max_iter`` L-BFGS iterations, as sklearn's ``max_iter``.  Returns
    (classes, W (d, c), b (c,)), c = 1 for two classes."""
    from scipy.optimize import minimize
    from scipy.special import log_softmax, softmax
    x = np.asarray(x, np.float64)
    classes, yi = np.unique(y, return_inverse=True)
    n, d = x.shape
    c = 1 if len(classes) == 2 else len(classes)
    onehot = np.eye(len(classes))[yi]
    reg = 1.0 / (LOGREG_C * n)

    def loss(theta):
        w, b = theta[:d * c].reshape(d, c), theta[d * c:]
        logits = x @ w + b
        if c == 1:   # binary: log(1 + exp(-t s)), t = +-1
            t = 2.0 * yi - 1.0
            m = -t * logits[:, 0]
            value = np.logaddexp(0.0, m).sum()
            g = (-t * softmax(np.stack([np.zeros(n), m], 1), axis=1)[:, 1])[:, None]
        else:
            value = -(onehot * log_softmax(logits, axis=1)).sum()
            g = softmax(logits, axis=1) - onehot
        value = value / n + 0.5 * reg * (w ** 2).sum()
        grad_w = x.T @ g / n + reg * w
        return value, np.concatenate([grad_w.ravel(), g.sum(0) / n])

    res = minimize(loss, np.zeros(d * c + c), jac=True, method="L-BFGS-B",
                   options={"maxiter": max_iter, "maxls": 50, "gtol": LOGREG_TOL,
                            "ftol": 64 * np.finfo(float).eps})
    return classes, res.x[:d * c].reshape(d, c), res.x[d * c:]


def logreg_predict(fit, x: np.ndarray) -> np.ndarray:
    classes, w, b = fit
    logits = np.asarray(x, np.float64) @ w + b
    if w.shape[1] == 1:
        return classes[(logits[:, 0] > 0).astype(int)]
    return classes[logits.argmax(1)]


def _ridge_r2(z: np.ndarray, y: np.ndarray, seed: int = 0) -> float:
    """Held-out R^2 of a ridge probe z -> y (mean over target dims)."""
    tr, te = _split(len(z), seed)
    w, b = ridge_fit(z[tr], y[tr])
    return r2_score(y[te], np.asarray(z[te], np.float64) @ w + b)


def _logreg_acc(z: np.ndarray, y: np.ndarray, seed: int = 0) -> float:
    tr, te = _split(len(z), seed)
    if len(np.unique(y[tr])) < 2:
        return float((y[te] == y[tr][0]).mean())
    return float((logreg_predict(logreg_fit(z[tr], y[tr]), z[te]) == y[te]).mean())


def probe_report(exp, env_id: str = "NLReach2-v0", scenes_n: int = 400,
                 seed: int = 0) -> Dict[str, float]:
    roles = modality_roles(exp)
    img_idx = int(roles["image"].split("_")[1]) - 1
    img_size = int(exp.config.mods[img_idx].feature_dims[0])
    scenes = collect_scenes(env_id, scenes_n, seed, img_size=img_size)
    img, lang = roles["image"], roles["language"]
    z_img = _posterior_means(exp, roles, scenes, (img,))
    z_lang = _posterior_means(exp, roles, scenes, (lang,))
    z_joint = _posterior_means(exp, roles, scenes, (img, lang))

    ep_true = _predicted_endpoints(exp, roles, scenes, scenes["instrs"])
    ep_flip = _predicted_endpoints(exp, roles, scenes, scenes["flips"])
    goal = scenes["goal_off"]
    goal_norm = np.linalg.norm(goal, axis=1)
    ep_norm = np.linalg.norm(ep_true, axis=1)
    cos = (ep_true * goal).sum(1) / np.maximum(ep_norm * goal_norm, 1e-9)

    return {
        "probe_img_to_obj_pos_r2": _ridge_r2(z_img, scenes["obj_pos"]),
        "probe_lang_to_goal_color_acc": _logreg_acc(z_lang,
                                                    scenes["goal_color"]),
        "probe_joint_to_obj_pos_r2": _ridge_r2(z_joint, scenes["obj_pos"]),
        "probe_joint_to_goal_offset_r2": _ridge_r2(z_joint, goal),
        "flip_endpoint_shift_m": float(
            np.linalg.norm(ep_true - ep_flip, axis=1).mean()),
        "endpoint_shrink_ratio": float(
            np.median(ep_norm / np.maximum(goal_norm, 1e-9))),
        "endpoint_goal_cosine": float(cos.mean()),
        "scenes": float(scenes_n),
    }


def main(argv=None):
    from multimodal_vae_comparison_tpu_torch.device import set_numerics
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    set_numerics()
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True, help="trained run dir")
    parser.add_argument("--env", default="NLReach2-v0")
    parser.add_argument("--scenes", type=int, default=400)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="where the model runs: CUDA unless 'cpu'")
    args = parser.parse_args(argv)
    exp = MultimodalVAEInfer(args.model, device=args.device)
    stats = probe_report(exp, args.env, args.scenes, args.seed)
    print(stats)
    from multimodal_vae_comparison_tpu_torch.utils import print_save_stats
    print_save_stats(
        {k: {"value": float(v), "stdev": None} for k, v in stats.items()},
        args.model, f"vilanro_probe_{args.env}")


if __name__ == "__main__":
    main()
