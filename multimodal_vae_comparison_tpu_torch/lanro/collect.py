"""VILANRO dataset collection: scripted-policy rollouts -> pkl modality files.

A copy of the JAX package's ``lanro/collect.py`` (numpy and cv2 only): for
the same seed and options it writes the same files, byte for byte.  It
rolls a scripted expert in the language-conditioned env and dumps the
trimodal dataset in the file layout the VILANRO dataset class loads
(image_final.pkl, instructions_final.pkl, endeff_actions_final.pkl,
vocab.txt).  The DAgger round (``--dagger_model``) rolls a run of the
port's own, restored through ``eval/infer.py``, on the card unless
``--device cpu`` is given.

    python -m multimodal_vae_comparison_tpu_torch.lanro.collect \
        --env NLReach2-v0 --episodes 2000 --out data/vilanro/D1

The recipes of the waypoint configs' data (NLReach2-v0, seed 0; the
expert succeeds in every episode):

* ``D1way_p2`` (``round3/vilanro_r3_way_p2*``, ``round4/vilanro_r4_cond``):
  2,000 scenes, hindsight chunks every 5 steps, as start-relative
  waypoints: ``--episodes 2000 --chunk_every 5 --waypoints``;
* ``D1way_r4`` (``round4/vilanro_r4b_spatial``): the same at 8,000
  episodes, 14,214 samples: ``--episodes 8000 --chunk_every 5 --waypoints``;
* ``D1way_r5`` (``round5/vilanro_r5_128``): D1way_r4's recipe rendered at
  128 px: ``--episodes 8000 --chunk_every 5 --waypoints --size 128``.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import List

import numpy as np

from multimodal_vae_comparison_tpu_torch.lanro.env import LanroEnv, make


def _push_toward(env: LanroEnv, goal, target_xy: np.ndarray,
                 fine: bool = False) -> np.ndarray:
    """Phased directional push: hover behind the object (relative to the
    push direction), descend, then sweep it toward target_xy.  ``fine``
    shrinks the sweep near the target (gentle taps for gliding pucks)."""
    ee = env.sim.ee
    to_t = np.asarray(target_xy) - goal.pos[:2]
    d = float(np.linalg.norm(to_t))
    dirn = to_t / (d + 1e-9)
    behind = goal.pos[:2] - dirn * (goal.size + 0.03)
    aligned = np.linalg.norm(ee[:2] - behind) < 0.015
    near_obj = np.linalg.norm(ee[:2] - goal.pos[:2]) < goal.size + 0.05
    if not aligned:
        if ee[2] < 0.09 and near_obj:
            # rise before repositioning so we don't shove the object sideways
            delta = np.array([0.0, 0.0, 0.05])
        else:
            delta = np.array([behind[0] - ee[0], behind[1] - ee[1],
                              0.11 - ee[2]])
    elif ee[2] > 0.04:
        delta = np.array([0.0, 0.0, 0.03 - ee[2]])
    else:
        if fine:
            # Coulomb dynamics: a hit at speed v glides v^2/2a, so the
            # correct tap speed for the remaining distance is sqrt(2 a d)
            # (golf-putt expert; privileged knowledge of the table's mu)
            from multimodal_vae_comparison_tpu_torch.lanro.simulation import MU_ACCEL
            a = max(env.sim.friction * MU_ACCEL, 1e-6)
            step = float(np.clip(np.sqrt(2.0 * a * d), 0.004, 0.04))
        else:
            step = 0.04
        delta = np.array([dirn[0] * step, dirn[1] * step, 0.0])
    step3 = np.clip(delta, -0.04, 0.04)
    return np.array([step3[0], step3[1], step3[2], 1.0], np.float32)


def _ee_policy(env: LanroEnv) -> np.ndarray:
    """One expert EE action for any registered task."""
    if env.task == "empty":
        step = np.clip(env.sim.target - env.sim.ee, -0.04, 0.04)
        return np.array([step[0], step[1], step[2], 1.0], np.float32)
    goal = env.goal_object
    delta = goal.pos - env.sim.ee
    dist = np.linalg.norm(delta)
    grip = 1.0
    if env.task == "reach":
        pass
    elif env.task == "pickplace":
        # grasp, carry over the target, release (the object settles at the
        # table rest height under the release xy — simulation._post_motion)
        if not goal.grasped:
            grip = 1.0 if dist > 0.03 else -1.0
        else:
            above = np.linalg.norm(
                env.sim.ee[:2] - env.sim.target[:2]) < 0.02
            delta = np.array([env.sim.target[0] - env.sim.ee[0],
                              env.sim.target[1] - env.sim.ee[1],
                              0.08 - env.sim.ee[2]])
            grip = 1.0 if above else -1.0
    elif env.task == "push":
        # approach slightly behind, then push through
        if dist < 0.06:
            delta = delta + delta / (dist + 1e-9) * 0.05
    elif env.task in ("left", "right"):
        sign = -1.0 if env.task == "left" else 1.0
        target_xy = env._initial_pos[:2] + np.array([sign * 0.12, 0.0])
        return _push_toward(env, goal, target_xy)
    elif env.task == "slide":
        return _push_toward(env, goal, env.sim.target[:2], fine=True)
    elif env.task == "stack":
        base = env.sim.objects[env.base_idx]
        drop = base.pos + np.array([0.0, 0.0, base.size + goal.size + 0.01])
        if not goal.grasped:
            grip = 1.0 if dist > 0.03 else -1.0
        else:
            above = np.linalg.norm(env.sim.ee[:2] - drop[:2]) < 0.02
            delta = drop - env.sim.ee
            grip = 1.0 if above and env.sim.ee[2] >= drop[2] - 0.01 else -1.0
    else:  # lift / grasp
        if dist > 0.03 and not goal.grasped:
            grip = 1.0
        elif not goal.grasped:
            grip = -1.0
        else:
            delta = np.array([0.0, 0.0, 0.05])
            grip = -1.0
    step = np.clip(delta, -0.04, 0.04)
    return np.array([step[0], step[1], step[2], grip], np.float32)


def scripted_policy(env: LanroEnv) -> np.ndarray:
    """Expert action in the env's native action space.  For
    ``relative_joints`` envs the Cartesian expert step is converted to joint
    deltas through the arm's IK (the same controller hierarchy the reference
    uses for scripted Panda demos)."""
    ee_action = _ee_policy(env)
    if env.action_type != "relative_joints":
        return ee_action
    from multimodal_vae_comparison_tpu_torch.lanro.simulation import MAX_JOINT_STEP
    sim = env.sim
    target = sim.ee + ee_action[:3]
    q_new = sim.arm.ik(sim.joints.copy(), target)
    dq = np.clip((q_new - sim.joints) / MAX_JOINT_STEP, -1.0, 1.0)
    return np.concatenate([dq, [ee_action[3]]]).astype(np.float32)


def collect(env_id: str, episodes: int, out_dir: str, seed: int = 0,
            max_len: int = 100, chunk_every: int = 0,
            noise: float = 0.0, waypoints: bool = False,
            img_size: int = 64) -> dict:
    """Roll the scripted expert and dump the trimodal pkl layout.

    ``chunk_every=k`` additionally emits hindsight action-chunk samples:
    for every k-th mid-episode step the *current* frame is paired with the
    remaining trajectory suffix.  Trained on these, the model's cross
    generation is in-distribution for receding-horizon replanning
    (vilanro_test --replan k), which the initial-frame-only data is not —
    round-1 measured replanning *below* open-loop for exactly that reason.

    ``waypoints=True`` stores each trajectory as *start-relative achieved EE
    positions* (w_t = ee_{t+1} - ee_{t0}, gripper channel kept raw) instead
    of per-step deltas.  Replay converts back via first differences
    (vilanro_test).  Rationale: under the open-loop protocol the success
    predicate depends on the trajectory *endpoint*; decoding 70 per-step
    deltas compounds per-step regression error ~sqrt(T) (measured round 2:
    val delta MSE 1.3e-4 -> ~8 cm endpoint drift, tolerance 5 cm), while a
    waypoint head makes the endpoint a single prediction.  Waypoints are
    diffs of *achieved* (clip-respecting) positions, so the replayed deltas
    are always feasible for the env.

    ``noise > 0`` executes the expert with Gaussian action noise (DART,
    Laskey et al. 2017) and relabels every recorded state with the *clean*
    expert's remaining trajectory (expert_suffix) — covering the
    neighborhood of the expert manifold that closed-loop drift actually
    visits, without the distribution mismatch a learned-policy DAgger round
    inherits from a weak model.  Because labels come from the clean expert,
    the noisy rollout never needs to finish the task: it is cut at
    ``noise_steps`` so the state distribution stays near-manifold instead
    of deep in random-walk territory."""
    os.makedirs(out_dir, exist_ok=True)
    env = make(env_id, seed=seed, img_size=img_size)
    rng = np.random.default_rng(seed)
    images: List[np.ndarray] = []
    instructions: List[str] = []
    trajectories: List[np.ndarray] = []
    successes = 0
    noise_steps = 12
    for ep in range(episodes):
        obs = env.reset()
        frames = [obs["rgb"]]        # frame before each action
        instruction = env.instruction
        traj = []
        ee_log = [env.sim.ee.copy()]  # achieved EE position after each step
        suffixes = []                # clean relabels of each visited state
        done = False
        while not done and len(traj) < (noise_steps if noise else max_len):
            action = scripted_policy(env)
            if noise:
                suffixes.append(expert_suffix(env, max_len,
                                              waypoints=waypoints))
                action = np.clip(
                    action + rng.normal(0.0, noise, action.shape), -1.0, 1.0
                ).astype(np.float32)
            traj.append(action)
            obs, reward, done, info = env.step(action)
            frames.append(obs["rgb"])
            ee_log.append(env.sim.ee.copy())
        successes += int(env.is_success())
        if noise:
            # every visited (noisy-rollout) state, clean-expert-labeled
            for t in range(0, len(suffixes), max(chunk_every, 1)):
                images.append(frames[t])
                instructions.append(instruction)
                trajectories.append(suffixes[t])
            continue
        emit = (_to_waypoints if waypoints
                else lambda tr, log, t0: np.stack(tr[t0:]))
        images.append(frames[0])     # initial scene: what the policy sees
        instructions.append(instruction)
        trajectories.append(emit(traj, ee_log, 0))
        if chunk_every:
            for t in range(chunk_every, len(traj), chunk_every):
                images.append(frames[t])
                instructions.append(instruction)
                trajectories.append(emit(traj, ee_log, t))
    vocab = sorted({w for ins in instructions for w in ins.split(" ")})
    with open(os.path.join(out_dir, "image_final.pkl"), "wb") as f:
        pickle.dump(images, f)
    with open(os.path.join(out_dir, "instructions_final.pkl"), "wb") as f:
        pickle.dump(instructions, f)
    with open(os.path.join(out_dir, "endeff_actions_final.pkl"), "wb") as f:
        pickle.dump(trajectories, f)
    with open(os.path.join(out_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    return {"episodes": episodes, "samples": len(trajectories),
            "expert_success": successes / episodes,
            "vocab_size": len(vocab), "out_dir": out_dir}


def _to_waypoints(traj, ee_log, t0: int) -> np.ndarray:
    """Start-relative achieved EE positions (w_k = ee_{t0+k+1} - ee_{t0}),
    gripper command kept raw, for the trajectory suffix starting at step
    ``t0``.  Always 4-dim (x, y, z, gripper) regardless of the env's native
    action space — achieved Cartesian positions are well-defined for the
    joint-space arm too."""
    return np.stack([
        np.concatenate([np.asarray(ee_log[k + 1] - ee_log[t0], np.float32),
                        np.asarray(traj[k][-1:], np.float32)])
        for k in range(t0, len(traj))])


def expert_suffix(env, max_len: int = 100,
                  waypoints: bool = False) -> np.ndarray:
    """Expert's remaining trajectory from the env's *current* state, rolled
    on a deep copy (the kinematic sim is pure numpy, cloning is cheap)."""
    import copy
    sim_env = copy.deepcopy(env)
    sim_env.render_obs = False   # obs frames are discarded; skip rendering
    traj = []
    ee_log = [sim_env.sim.ee.copy()]
    done = False
    while not done and len(traj) < max_len:
        a = scripted_policy(sim_env)
        traj.append(a)
        _, _, done, _ = sim_env.step(a)
        ee_log.append(sim_env.sim.ee.copy())
    if not traj:
        traj = [np.zeros_like(scripted_policy(sim_env))]
        ee_log.append(ee_log[0])
    return _to_waypoints(traj, ee_log, 0) if waypoints else np.stack(traj)


def collect_dagger(env_id: str, episodes: int, out_dir: str, model_dir: str,
                   seed: int = 0, max_len: int = 100,
                   rollout_steps: int = 15, batch: int = 100,
                   mix_dir: str = None, device=None) -> dict:
    """DAgger round: roll the *trained model's* receding-horizon policy and
    label every visited state with the scripted expert's remaining
    trajectory.

    Open/closed-loop replay of cross-generated trajectories fails by
    compounding covariate shift: one slightly-off action puts the arm in a
    state the expert data never covers, and prediction quality collapses.
    Expert-labeling the *model-visited* state distribution is the standard
    correction (Ross et al. 2011).  ``mix_dir`` merges an existing expert
    dataset into the output so the result trains on both distributions.
    The model is the port's run in ``model_dir``, restored on ``device``
    (CUDA unless the caller passes "cpu")."""
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    exp = MultimodalVAEInfer(model_dir, device=device)
    mapping = {m.mod_type: m.name for m in exp.config.mods}
    lang_mod, act_mod = mapping["language"], mapping["actions"]
    img_mod = mapping.get("front RGB") or mapping.get("image")
    lang_idx = int(lang_mod.split("_")[1]) - 1
    vocab_model = exp.datamod.datasets[lang_idx].vocab
    L = exp.config.mods[lang_idx].feature_dims[0]

    def encode(obs_list):
        imgs = np.stack([o["rgb"] for o in obs_list]).astype(np.float32) / 255.
        oh = np.zeros((len(obs_list), L, len(vocab_model)), np.float32)
        mk = np.zeros((len(obs_list), L), bool)
        for b, o in enumerate(obs_list):
            words = [w for w in o["instruction"].split() if w in vocab_model]
            for i, w in enumerate(words[:L]):
                oh[b, i, vocab_model.index(w)] = 1.0
                mk[b, i] = True
        return {img_mod: {"data": imgs, "masks": None},
                lang_mod: {"data": oh, "masks": mk}}

    def policy_actions(obs_list):
        out = exp.forward(encode(obs_list), present=(img_mod, lang_mod))
        return out.mods[act_mod].decoder_dist.mean[0].cpu().numpy()[:, 0]

    images, instructions, trajectories = [], [], []
    rounds = max(episodes // batch, 1)
    for r in range(rounds):
        img_idx = int(img_mod.split("_")[1]) - 1
        img_size = int(exp.config.mods[img_idx].feature_dims[0])
        envs = [make(env_id, seed=seed + r * batch + t, img_size=img_size)
                for t in range(batch)]
        obs = [e.reset() for e in envs]
        done = np.zeros(batch, bool)
        for step in range(rollout_steps):
            # label every live state with the expert's remaining trajectory
            for b, e in enumerate(envs):
                if done[b]:
                    continue
                images.append(obs[b]["rgb"])
                instructions.append(obs[b]["instruction"])
                trajectories.append(expert_suffix(e, max_len))
            if done.all():
                break
            acts = policy_actions(obs)
            for b, e in enumerate(envs):
                if done[b]:
                    continue
                a = np.asarray(acts[b], np.float64).reshape(-1)
                obs[b], _, d, _ = e.step(a[: e.action_dim])
                done[b] = d
    if mix_dir:
        with open(os.path.join(mix_dir, "image_final.pkl"), "rb") as f:
            images = list(pickle.load(f)) + images
        with open(os.path.join(mix_dir, "instructions_final.pkl"), "rb") as f:
            instructions = list(pickle.load(f)) + instructions
        with open(os.path.join(mix_dir, "endeff_actions_final.pkl"), "rb") as f:
            trajectories = list(pickle.load(f)) + trajectories
    os.makedirs(out_dir, exist_ok=True)
    vocab = sorted({w for ins in instructions for w in ins.split(" ")})
    with open(os.path.join(out_dir, "image_final.pkl"), "wb") as f:
        pickle.dump(images, f)
    with open(os.path.join(out_dir, "instructions_final.pkl"), "wb") as f:
        pickle.dump(instructions, f)
    with open(os.path.join(out_dir, "endeff_actions_final.pkl"), "wb") as f:
        pickle.dump(trajectories, f)
    with open(os.path.join(out_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    return {"episodes": rounds * batch, "samples": len(trajectories),
            "vocab_size": len(vocab), "out_dir": out_dir,
            "mixed_from": mix_dir}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", default="NLReach2-v0")
    parser.add_argument("--episodes", type=int, default=2000)
    parser.add_argument("--out", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--size", type=int, default=64,
                        help="camera resolution (round 5: 128 with the "
                             "sub-pixel anti-aliased renderer)")
    parser.add_argument("--chunk_every", type=int, default=0,
                        help="also emit (mid-episode frame, remaining-"
                             "trajectory) hindsight chunks every k steps")
    parser.add_argument("--waypoints", action="store_true",
                        help="store trajectories as start-relative achieved "
                             "EE positions (single-prediction endpoint) "
                             "instead of per-step deltas")
    parser.add_argument("--noise", type=float, default=0.0,
                        help="DART: execute the expert with this Gaussian "
                             "action noise and clean-relabel visited states")
    parser.add_argument("--dagger_model", default=None,
                        help="trained run dir: roll ITS policy and expert-"
                             "label the visited states (DAgger round)")
    parser.add_argument("--mix_dir", default=None,
                        help="existing dataset dir to merge into the output")
    parser.add_argument("--device", default=None,
                        help="where --dagger_model runs: CUDA unless 'cpu'")
    args = parser.parse_args(argv)
    if args.dagger_model:
        from multimodal_vae_comparison_tpu_torch.device import set_numerics
        set_numerics()
        stats = collect_dagger(args.env, args.episodes, args.out,
                               args.dagger_model, args.seed,
                               mix_dir=args.mix_dir, device=args.device)
    else:
        stats = collect(args.env, args.episodes, args.out, args.seed,
                        chunk_every=args.chunk_every, noise=args.noise,
                        waypoints=args.waypoints, img_size=args.size)
    print(stats)


if __name__ == "__main__":
    main()
