"""Gym-style language-conditioned environments + registry.

Mirrors the reference's gymnasium registration surface
(lanro_gym/__init__.py:1-129): the NL task family (NLReach / NLPush /
NLLift / NLGrasp / NLLeft / NLRight, reference tasks/nl*.py) plus the
goal-conditioned Slide and Stack tasks (tasks/slide.py, tasks/stack.py),
over the kinematic backend (simulation.py) with an optional joint-space arm
(arm.py).

Two API surfaces:
* ``LanroEnv`` — the compact 4-tuple ``step`` used throughout this repo;
* ``GymnasiumEnv`` — gymnasium-signature wrapper (``reset(seed=...) ->
  (obs, info)``, 5-tuple ``step``, ``action_space``/``observation_space``)
  so reference code written against gymnasium ports over; a local ``spaces``
  shim stands in because gymnasium is not a dependency.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from multimodal_vae_comparison_tpu_torch.lanro.arm import NUM_DOF
from multimodal_vae_comparison_tpu_torch.lanro.simulation import (
    COLOR_MAP, KinematicSimulation, SHAPE_IDS)

# reach-success radius (m); vilanro_test's endpoint diagnostic derives its
# "within 2x tolerance" bucket from this
REACH_TOLERANCE = 0.05

INSTRUCTION_TEMPLATES = {
    "reach": ["reach the {color} {shape}", "touch the {color} {shape}"],
    "push": ["push the {color} {shape}", "move the {color} {shape}"],
    "lift": ["lift the {color} {shape}", "pick up the {color} {shape}"],
    "grasp": ["grasp the {color} {shape}", "grab the {color} {shape}"],
    "left": ["move the {color} {shape} to the left",
             "push the {color} {shape} left"],
    "right": ["move the {color} {shape} to the right",
              "push the {color} {shape} right"],
    "slide": ["slide the {color} {shape} to the target"],
    "stack": ["stack the {color} {shape} on the {color2} {shape2}",
              "put the {color} {shape} on the {color2} {shape2}"],
    # objectless EE-goal task (reference tasks/empty.py: the goal is a
    # sampled gripper target position, no scene objects)
    "empty": ["move the gripper to the target",
              "reach the target position"],
    # reference registers PickAndPlace as a 1-object Stack env with a
    # sampled goal position (lanro_gym/__init__.py:30-41)
    "pickplace": ["put the {color} {shape} on the target",
                  "place the {color} {shape} at the target"],
}


@dataclasses.dataclass(frozen=True)
class Box:
    """Minimal gymnasium.spaces.Box stand-in (gymnasium is not a dependency)."""
    low: np.ndarray
    high: np.ndarray

    @property
    def shape(self):
        return np.asarray(self.low).shape

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return rng.uniform(self.low, self.high).astype(np.float32)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape and (x >= self.low).all()
                and (x <= self.high).all())


class LanroEnv:
    """reset() -> obs dict; step(action) -> (obs, reward, done, info).

    obs = {"rgb": (64, 64, 3) uint8, "instruction": str, "ee", "gripper"}
    action = (dx, dy, dz, gripper) float32, or 7 joint deltas + gripper when
    ``action_type='relative_joints'`` (requires use_arm).
    """

    def __init__(self, task: str = "reach", num_objects: int = 2,
                 max_steps: int = 100, seed: int = 0,
                 use_arm: bool = False, action_type: str = "end_effector",
                 reward_type: str = "sparse", img_size: int = 64):
        assert task in INSTRUCTION_TEMPLATES
        assert action_type in ("end_effector", "relative_joints")
        if action_type == "relative_joints":
            use_arm = True
        self.task = task
        self.num_objects = (0 if task == "empty"
                            else max(num_objects, 2 if task == "stack" else 1))
        self.max_steps = max_steps
        self.action_type = action_type
        self.reward_type = reward_type
        self.img_size = int(img_size)
        friction = 0.05 if task == "slide" else 1.0
        self.sim = KinematicSimulation(seed, use_arm=use_arm,
                                       friction=friction)
        self.rng = np.random.default_rng(seed + 1)
        self.goal_idx = 0
        self.base_idx = 0          # stack: the object to stack onto
        self.instruction = ""
        self._t = 0
        self._initial_pos = None

    @property
    def action_dim(self) -> int:
        return (NUM_DOF + 1 if self.action_type == "relative_joints" else 4)

    # -- episode ---------------------------------------------------------------

    def reset(self) -> Dict:
        self.sim.reset(self.num_objects)
        tmpl = INSTRUCTION_TEMPLATES[self.task]
        template = tmpl[self.rng.integers(len(tmpl))]
        if self.task == "empty":
            self.goal_idx = 0
            # EE goal above the table (reference empty.py samples the
            # gripper target; the EE can hover, so z may be elevated)
            self.sim.target = np.array([self.rng.uniform(-0.2, 0.2),
                                        self.rng.uniform(-0.2, 0.2),
                                        self.rng.uniform(0.03, 0.15)])
            self.instruction = template
            self._t = 0
            self._initial_pos = self.sim.ee.copy()
            return self._obs()
        self.goal_idx = int(self.rng.integers(self.num_objects))
        goal = self.sim.objects[self.goal_idx]
        if self.task == "stack":
            others = [i for i in range(self.num_objects) if i != self.goal_idx]
            self.base_idx = int(others[self.rng.integers(len(others))])
            base = self.sim.objects[self.base_idx]
            self.instruction = template.format(
                color=goal.color, shape=goal.shape,
                color2=base.color, shape2=base.shape)
        else:
            self.instruction = template.format(color=goal.color,
                                               shape=goal.shape)
        if self.task in ("slide", "pickplace"):
            self.sim.sample_target()
            if self.task == "pickplace":
                # placement target at rest height: released objects settle
                # on the table (simulation._rest_height), so an achievable
                # goal sits at the table rest z — the reference's elevated
                # goal_z_range needs a surface to rest on we don't model
                self.sim.target[2] = 0.02
        self._t = 0
        self._initial_pos = goal.pos.copy()
        return self._obs()

    def step(self, action) -> Tuple[Dict, float, bool, Dict]:
        action = np.asarray(action, np.float64)
        assert action.shape[-1] == self.action_dim, (
            f"task '{self.task}' ({self.action_type}) expects "
            f"{self.action_dim}-dim actions, got {action.shape}")
        if self.action_type == "relative_joints":
            self.sim.joint_step(action)
        else:
            self.sim.step(action)
        self._t += 1
        success = self.is_success()
        done = success or self._t >= self.max_steps
        return self._obs(), self.compute_reward(success), done, \
            {"is_success": success}

    def compute_reward(self, success: bool) -> float:
        if self.reward_type == "sparse":
            return float(success)
        return -float(self._goal_distance())   # dense

    def _obs(self) -> Dict:
        # render_obs=False skips the cv2 rasterization for consumers that
        # never read obs["rgb"] (e.g. expert_suffix rollouts, which only
        # need the EE log — tens of thousands of frames per DAgger batch)
        rgb = (self.sim.render(self.img_size)
               if getattr(self, "render_obs", True) else None)
        obs = {"rgb": rgb, "instruction": self.instruction,
               "ee": self.sim.ee.copy(), "gripper": self.sim.gripper}
        if self.sim.use_arm:
            obs["joints"] = self.sim.joints.copy()
        if self.sim.target is not None:
            obs["target"] = self.sim.target.copy()
        return obs

    # -- success predicates (reference tasks/nl*.py, slide.py, stack.py) --------

    def _goal_distance(self) -> float:
        if self.task == "empty":
            return float(np.linalg.norm(self.sim.ee - self.sim.target))
        goal = self.sim.objects[self.goal_idx]
        if self.task == "pickplace":
            return float(np.linalg.norm(goal.pos - self.sim.target))
        if self.task == "reach":
            return float(np.linalg.norm(self.sim.ee - goal.pos))
        if self.task == "slide":
            return float(np.linalg.norm(goal.pos[:2] - self.sim.target[:2]))
        if self.task == "stack":
            base = self.sim.objects[self.base_idx]
            return float(np.linalg.norm(goal.pos[:2] - base.pos[:2]))
        return float(np.linalg.norm(self.sim.ee - goal.pos))

    def is_success(self) -> bool:
        if self.task == "empty":
            return bool(np.linalg.norm(self.sim.ee - self.sim.target)
                        < REACH_TOLERANCE)
        goal = self.sim.objects[self.goal_idx]
        if self.task == "pickplace":
            return bool(np.linalg.norm(goal.pos - self.sim.target) < 0.05
                        and not goal.grasped)
        if self.task == "reach":
            return bool(np.linalg.norm(self.sim.ee - goal.pos)
                        < REACH_TOLERANCE)
        if self.task == "push":
            moved = np.linalg.norm(goal.pos[:2] - self._initial_pos[:2])
            return bool(moved > 0.08)
        if self.task == "lift":
            return bool(goal.pos[2] > 0.10)
        if self.task == "grasp":
            return bool(goal.grasped and goal.pos[2] > 0.05)
        if self.task == "left":
            return bool(self._initial_pos[0] - goal.pos[0] > 0.08)
        if self.task == "right":
            return bool(goal.pos[0] - self._initial_pos[0] > 0.08)
        if self.task == "slide":
            return bool(np.linalg.norm(
                goal.pos[:2] - self.sim.target[:2]) < 0.05)
        # stack: xy-aligned, resting on top, not held
        base = self.sim.objects[self.base_idx]
        aligned = np.linalg.norm(goal.pos[:2] - base.pos[:2]) < 0.05
        on_top = abs(goal.pos[2] - (base.pos[2] + base.size + goal.size)) \
            < 0.02
        return bool(aligned and on_top and not goal.grasped)

    @property
    def goal_object(self):
        return self.sim.objects[self.goal_idx]


class GymnasiumEnv:
    """gymnasium-signature adapter over LanroEnv (reference envs are
    gymnasium.Env subclasses registered in lanro_gym/__init__.py)."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, **kwargs):
        self._env = LanroEnv(**kwargs)
        a = self._env.action_dim
        if self._env.action_type == "relative_joints":
            # joint mode scales [-1,1] commands by MAX_JOINT_STEP internally
            low, high = -np.ones(a, np.float32), np.ones(a, np.float32)
        else:
            # end-effector mode consumes raw meters clipped at MAX_STEP per
            # axis (simulation.step), gripper command in [-1,1]; advertise
            # the true envelope so action_space.sample()/contains match the
            # dynamics instead of saturating every |a| >= 0.04
            from multimodal_vae_comparison_tpu_torch.lanro.simulation import (
                MAX_STEP)
            low = np.array([-MAX_STEP] * 3 + [-1.0], np.float32)
            high = np.array([MAX_STEP] * 3 + [1.0], np.float32)
        self.action_space = Box(low=low, high=high)
        s = self._env.img_size
        self.observation_space = {
            "rgb": Box(low=np.zeros((s, s, 3), np.float32),
                       high=np.full((s, s, 3), 255, np.float32)),
        }

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._env.rng = np.random.default_rng(seed + 1)
            self._env.sim.rng = np.random.default_rng(seed)
        obs = self._env.reset()
        return obs, {}

    def step(self, action):
        obs, reward, done, info = self._env.step(action)
        terminated = bool(info["is_success"])
        truncated = bool(done and not terminated)
        return obs, reward, terminated, truncated, info

    def render(self):
        return self._env.sim.render(self._env.img_size)

    def close(self):
        pass

    def __getattr__(self, name):
        return getattr(self._env, name)


def _nl(task, n, **kw):
    return dict(task=task, num_objects=n, **kw)


ENV_REGISTRY = {
    # compact ids used throughout this repo
    "NLReach2-v0": _nl("reach", 2), "NLReach3-v0": _nl("reach", 3),
    "NLPush2-v0": _nl("push", 2), "NLPush3-v0": _nl("push", 3),
    "NLLift2-v0": _nl("lift", 2), "NLLift3-v0": _nl("lift", 3),
    "NLGrasp2-v0": _nl("grasp", 2), "NLGrasp3-v0": _nl("grasp", 3),
    "NLLeft2-v0": _nl("left", 2), "NLLeft3-v0": _nl("left", 3),
    "NLRight2-v0": _nl("right", 2), "NLRight3-v0": _nl("right", 3),
    "Slide-v0": dict(task="slide", num_objects=1),
    "Stack2-v0": _nl("stack", 2), "Stack3-v0": _nl("stack", 3),
    "Empty-v0": dict(task="empty", num_objects=0),
    "PickAndPlace-v0": dict(task="pickplace", num_objects=1),
    "NLPickAndPlace2-v0": _nl("pickplace", 2),
}
# reference-style Panda ids (lanro_gym/__init__.py registrations) map to the
# same tasks with the joint-space arm enabled
for _task, _name in (("reach", "Reach"), ("push", "Push"), ("lift", "Lift"),
                     ("grasp", "Grasp"), ("left", "Left"), ("right", "Right")):
    for _n in (2, 3):
        ENV_REGISTRY[f"PandaNL{_name}{_n}-v0"] = _nl(
            _task, _n, use_arm=True, action_type="relative_joints")
ENV_REGISTRY["PandaSlide-v0"] = dict(task="slide", num_objects=1,
                                     use_arm=True,
                                     action_type="relative_joints")
ENV_REGISTRY["PandaEmpty-v0"] = dict(task="empty", num_objects=0,
                                     use_arm=True,
                                     action_type="relative_joints")
ENV_REGISTRY["PandaPickAndPlace-v0"] = dict(task="pickplace", num_objects=1,
                                            use_arm=True,
                                            action_type="relative_joints")
for _n in (2, 3):
    ENV_REGISTRY[f"PandaStack{_n}-v0"] = _nl(
        "stack", _n, use_arm=True, action_type="relative_joints")


def make(env_id: str, seed: int = 0, gymnasium_api: bool = False, **kwargs):
    if env_id not in ENV_REGISTRY:
        raise KeyError(f"unknown env '{env_id}'; available: "
                       f"{sorted(ENV_REGISTRY)}")
    params = dict(ENV_REGISTRY[env_id])
    params.update(kwargs)
    cls = GymnasiumEnv if gymnasium_api else LanroEnv
    return cls(seed=seed, **params)
