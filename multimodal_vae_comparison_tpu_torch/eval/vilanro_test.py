"""VILANRO closed-loop evaluation: image+instruction -> predicted action
trajectory -> env replay -> success rate.

Counterpart of the JAX package's ``eval/vilanro_test.py``: for N trials
the trained trimodal model cross-generates the action sequence from the
current camera image and the NL instruction, the trajectory is replayed in
the port's copy of the environment (``lanro/``), and the task success
predicate scores the episode.  The model is restored on the card unless
``--device cpu`` is given; the stats go to
``<run>/vilanro_<env>_replan<k>[_cal]_stats.txt``.

    python -m multimodal_vae_comparison_tpu_torch.eval.vilanro_test \
        --model results/vilanro_mvae/version_0 --env NLReach2-v0 --trials 500
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from multimodal_vae_comparison_tpu_torch.lanro.env import make


def endpoint_calibration_gain(exp, img_mod: str, lang_mod: str, act_mod: str,
                              act_waypoints: bool, n: int = 512) -> float:
    """Train-split endpoint-magnitude calibration.

    Mean-decoded trajectories systematically under-shoot (regression to the
    dataset mean; measured 0.15-0.2x on the round-3 waypoint runs).  This
    fits a single scalar gain on the TRAINING split — median ratio of true
    to predicted endpoint norms under the same image+language conditioning
    the evaluator uses — so the correction never sees the eval scenes.
    Standard output calibration (cf. temperature scaling); reported
    separately from the uncalibrated reference-protocol number."""
    batch, _ = exp.get_test_samples(n, split="train")
    inputs = {img_mod: batch[img_mod], lang_mod: batch[lang_mod]}
    out = exp.forward(inputs, present=(img_mod, lang_mod))
    raw = out.mods[act_mod].decoder_dist.mean[0].cpu().numpy()
    true = np.asarray(batch[act_mod]["data"])
    masks = batch[act_mod].get("masks")
    if act_waypoints:
        pred_ep = raw[:, -1, :3]
        if masks is not None and masks is not False and np.ndim(masks) == 2:
            last = np.maximum(masks.sum(axis=1).astype(int) - 1, 0)
            true_ep = true[np.arange(len(true)), last, :3]
        else:
            true_ep = true[:, -1, :3]
    else:
        pred_ep = raw[..., :3].sum(axis=1)
        true_ep = true[..., :3].sum(axis=1)
    ratio = (np.linalg.norm(true_ep, axis=1)
             / np.maximum(np.linalg.norm(pred_ep, axis=1), 1e-6))
    return float(np.clip(np.median(ratio), 1.0, 10.0))


def infer_loop(exp, env_id: str = "NLReach2-v0", trials: int = 500,
               seed: int = 0, log_every: int = 100,
               replan_every: int = 0, gain: float = 1.0,
               calibrate: bool = False) -> Dict[str, float]:
    """Closed-loop eval of a trained trimodal model (image+language+actions).

    ``replan_every=0`` replays one open-loop trajectory inferred from the
    initial image — the reference protocol (vilanro_test.py:277-346, one
    forward then up to 70 blind steps).  ``replan_every=k`` re-infers the
    trajectory from the *current* camera image every k steps and executes
    the first k actions (receding-horizon control) — an extra capability
    mode reported separately from the reference-protocol number.

    All trials run in lockstep with *batched* model forwards: the
    reference's loop does one forward per trial-step (vilanro_test.py:307),
    which on a remote accelerator is thousands of tiny dispatches; batching
    the population turns a replan-every-step eval into at most
    ``max_steps`` forwards total, ~trials x fewer."""
    # camera resolution follows the trained image modality (round 5: 128x128
    # sub-pixel renders) so eval observations match the training data
    _map = {m.mod_type: m for m in exp.config.mods}
    _img = _map.get("front RGB") or _map.get("image")
    img_size = int(_img.feature_dims[0]) if _img is not None else 64
    envs = [make(env_id, seed=seed + 1000 * t, img_size=img_size)
            for t in range(trials)]
    env_adim = getattr(envs[0], "action_dim", 4)
    assert env_adim == 4, (
        f"{env_id} expects {env_adim}-dim actions; this evaluator replays "
        "4-dim end-effector trajectories (dx,dy,dz,gripper — the reference "
        "protocol).  Joint-space Panda*/relative_joints envs need a model "
        "trained on 8-dim joint trajectories and are not supported here.")
    # modality roles from config mod_types
    mapping = {m.mod_type: m.name for m in exp.config.mods}
    lang_mod = mapping.get("language")
    act_type = next((t for t in ("actions", "action_tokens",
                                 "action_waypoints") if t in mapping), None)
    act_mod = mapping.get(act_type) if act_type else None
    # decode flags must follow the modality act_mod resolved to, not merely
    # which mod_types exist somewhere in the config
    act_tokens = act_type == "action_tokens"
    act_waypoints = act_type == "action_waypoints"
    img_mod = mapping.get("front RGB") or mapping.get("image")
    assert lang_mod and act_mod and img_mod, (
        f"expected language/actions/front RGB modalities, got {mapping}")
    lang_idx = int(lang_mod.split("_")[1]) - 1
    lang_ds = exp.datamod.datasets[lang_idx]
    act_ds = exp.datamod.datasets[int(act_mod.split("_")[1]) - 1]
    vocab = lang_ds.vocab
    lang_dims = exp.config.mods[lang_idx].feature_dims

    def encode_instruction(instruction: str):
        words = [w for w in instruction.split(" ") if w in vocab]
        idx = np.zeros((lang_dims[0],), np.int64)
        mask = np.zeros((lang_dims[0],), bool)
        for i, w in enumerate(words[: lang_dims[0]]):
            idx[i] = vocab.index(w)
            mask[i] = True
        return np.eye(len(vocab), dtype=np.float32)[idx], mask

    def predict_trajs(obs_list):
        imgs = np.stack([o["rgb"] for o in obs_list]).astype(np.float32) / 255.0
        enc = [encode_instruction(o["instruction"]) for o in obs_list]
        onehots = np.stack([e[0] for e in enc])
        masks = np.stack([e[1] for e in enc])
        inputs = {
            img_mod: {"data": imgs, "masks": None},
            lang_mod: {"data": onehots, "masks": masks},
        }
        out = exp.forward(inputs, present=(img_mod, lang_mod))
        raw = out.mods[act_mod].decoder_dist.mean[0].cpu().numpy()
        if act_tokens:
            # (B,T,A,K) token scores -> argmax bin centers (B,T,A); the
            # categorical head has no regression-to-the-mean shrink
            return act_ds.decode_output(raw)
        if act_waypoints:
            # (B,T,4) start-relative achieved-EE-position waypoints ->
            # per-step deltas by first differences (gripper channel raw).
            # Endpoint accuracy is then a SINGLE prediction instead of a
            # sum of T per-step delta predictions (collect.py --waypoints).
            deltas = np.diff(raw[..., :3], axis=1,
                             prepend=np.zeros_like(raw[..., :1, :3]))
            return np.concatenate([deltas, raw[..., 3:]], axis=-1)
        return raw  # (B,T,A) regression mean

    cal_gain = 1.0
    if calibrate:
        cal_gain = endpoint_calibration_gain(exp, img_mod, lang_mod, act_mod,
                                             act_waypoints)
        gain = gain * cal_gain
        print(f"endpoint calibration gain (train split): {cal_gain:.3f}")

    obs = [env.reset() for env in envs]
    trajs = predict_trajs(obs)
    horizon = trajs.shape[1]
    done = np.zeros(trials, bool)
    for step in range(horizon):
        if done.all():
            break
        t_idx = step if not replan_every else step % replan_every
        for b, env in enumerate(envs):
            if done[b]:
                continue
            action = np.asarray(trajs[b, t_idx], np.float64).reshape(-1)[:4]
            if action.shape[0] < 4:
                action = np.concatenate([action, [1.0]])
            if gain != 1.0:
                # amplify the commanded deltas (keeps the gripper channel),
                # clipped to the env's action range — counteracts the
                # systematic magnitude shrink of mean-decoded trajectories
                action = np.concatenate(
                    [np.clip(action[:3] * gain, -1.0, 1.0), action[3:]])
            obs[b], _, d, _ = env.step(action)
            done[b] = d
        if replan_every and (step + 1) % replan_every == 0 and not done.all():
            # one batched forward refreshes every live trial's plan (done
            # trials ride along — batching makes their cost ~free and keeps
            # the batch shape static)
            trajs = predict_trajs(obs)
        if log_every and (step + 1) % max(log_every // 10, 1) == 0:
            print(f"step {step + 1}/{horizon}: "
                  f"{int(done.sum())}/{trials} trials finished")
    successes = sum(int(env.is_success()) for env in envs)
    out = {"success_rate": successes / trials, "trials": trials,
           "replan_every": replan_every}
    if calibrate:
        out["calibration_gain"] = cal_gain
    # endpoint-error diagnostic (REACH only — for push/lift the EE-goal
    # distance is not the success criterion): a bare success rate hides
    # whether misses are near (tolerance-limited) or far (wrong target /
    # compounding drift) — the action-representation work keys on this
    if getattr(envs[0], "task", None) == "reach":
        from multimodal_vae_comparison_tpu_torch.lanro.env import REACH_TOLERANCE
        dists = np.array([env._goal_distance() for env in envs])
        out.update({
            "goal_dist_mean": float(dists.mean()),
            "goal_dist_median": float(np.median(dists)),
            "goal_dist_p25": float(np.percentile(dists, 25)),
            "within_2x_tolerance": float(
                (dists < 2 * REACH_TOLERANCE).mean())})
        # grounding vs precision: which object did the EE end nearest?
        # A high distractor rate means the instruction isn't steering the
        # generated trajectory (fusion/grounding failure); a low one with
        # large goal_dist means endpoint regression error instead.
        if len(envs[0].sim.objects) > 1:
            obj_d = np.array([[np.linalg.norm(env.sim.ee - o.pos)
                               for o in env.sim.objects] for env in envs])
            goal_ids = np.array([env.goal_idx for env in envs])
            out["nearest_is_distractor"] = float(
                (obj_d.argmin(axis=1) != goal_ids).mean())
            distractor_d = np.array([
                np.delete(obj_d[b], goal_ids[b]).min()
                for b in range(len(envs))])
            out["distractor_within_tolerance"] = float(
                (distractor_d < REACH_TOLERANCE).mean())
    return out


def main():
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True, help="trained run dir")
    parser.add_argument("--env", default="NLReach2-v0")
    parser.add_argument("--trials", type=int, default=500)
    parser.add_argument("--replan", type=int, default=0,
                        help="re-infer from the current image every k steps "
                             "(0 = reference open-loop protocol)")
    parser.add_argument("--gain", type=float, default=1.0,
                        help="scale commanded action deltas (clipped)")
    parser.add_argument("--calibrate", action="store_true",
                        help="fit a scalar endpoint-magnitude gain on the "
                             "TRAIN split and apply it (reported separately "
                             "from the uncalibrated protocol number)")
    parser.add_argument("--device", default=None,
                        help="where the model runs: CUDA unless 'cpu'")
    args = parser.parse_args()
    exp = MultimodalVAEInfer(args.model, device=args.device)
    stats = infer_loop(exp, args.env, args.trials,
                       replan_every=args.replan, gain=args.gain,
                       calibrate=args.calibrate)
    print(stats)
    # same stats-txt artifact contract as the dataset benchmarks
    from multimodal_vae_comparison_tpu_torch.utils import print_save_stats
    print_save_stats(
        {k: {"value": float(v), "stdev": None} for k, v in stats.items()},
        args.model, f"vilanro_{args.env}_replan{args.replan}"
                    + ("_cal" if args.calibrate else ""))


if __name__ == "__main__":
    main()
