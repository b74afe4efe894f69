"""Kinematic tabletop simulation + top-down renderer.

Replaces the reference's PyBulletSimulation/PyBulletRobot pair
(lanro_gym/simulation.py:23, robots/pybrobot.py:17) with an analytic world:

* the end-effector either integrates clamped velocity commands directly or
  tracks them through the 7-DoF joint-space arm (arm.py — the Panda
  stand-in), with a ``relative_joints`` action mode like the reference;
* objects carry planar velocity with per-world friction, so pushes displace
  (high friction) or glide (low friction — the Slide task's pucks,
  reference tasks/slide.py:36-44);
* releasing a grasped object above another stacks it (reference
  tasks/stack.py goal semantics);
* the camera is a top-down cv2 rasterizer emitting the same 64x64x3 RGB
  observations the VILANRO dataset carries.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from multimodal_vae_comparison_tpu_torch.lanro.arm import (
    ArmKinematics, JOINT_LIMITS, NEUTRAL_JOINT_VALUES, NUM_DOF)

WORKSPACE = np.array([[-0.3, 0.3], [-0.3, 0.3], [0.0, 0.3]])  # x, y, z bounds
MAX_STEP = 0.04          # max EE displacement per step (m)
MAX_JOINT_STEP = 0.15    # max per-joint delta per step (rad)
GRASP_RADIUS = 0.05      # proximity for a successful grasp
# Coulomb kinetic friction: per-step velocity decrement = friction * MU_ACCEL
# (normalized mu*g*dt^2).  friction=1.0 (push/stack tables) stops an object
# within one step of losing contact — quasi-static pushing; friction=0.05
# (the Slide task's pucks, reference tasks/slide.py lateral_friction=0.1)
# lets a full-speed 0.04 hit glide ~0.35 m.
MU_ACCEL = 0.045
RESTITUTION = 0.2        # object-object collision bounciness
GRAVITY_STEP = 0.03      # fall speed (m/step) for unsupported objects

SHAPE_IDS = ["cube", "cylinder", "sphere"]
COLOR_MAP = {"red": (200, 40, 40), "green": (40, 180, 60),
             "blue": (40, 90, 210), "yellow": (230, 210, 60),
             "purple": (150, 60, 180), "orange": (240, 140, 40)}


@dataclasses.dataclass
class SceneObject:
    shape: str
    color: str
    pos: np.ndarray           # (3,)
    size: float = 0.03
    grasped: bool = False
    vel: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2))


class KinematicSimulation:
    """``use_arm=True`` routes EE motion through joint-space IK; ``friction``
    in (0, 1] is the per-step planar velocity decay (1 = stops instantly)."""

    def __init__(self, seed: int = 0, use_arm: bool = False,
                 friction: float = 1.0):
        self.rng = np.random.default_rng(seed)
        self.objects: List[SceneObject] = []
        self.use_arm = use_arm
        self.friction = float(friction)
        self.arm = ArmKinematics() if use_arm else None
        self.joints = NEUTRAL_JOINT_VALUES.copy()
        self.ee = np.array([0.0, 0.0, 0.15])
        self.gripper = 1.0   # 1 = open, 0 = closed
        self.target: Optional[np.ndarray] = None  # goal marker (slide)

    # -- world setup ------------------------------------------------------------

    def reset(self, num_objects: int = 2,
              colors: Optional[List[str]] = None,
              shapes: Optional[List[str]] = None) -> None:
        self.gripper = 1.0
        self.objects = []
        self.target = None
        if self.use_arm:
            self.joints = NEUTRAL_JOINT_VALUES.copy()
            self.joints = self.arm.ik(self.joints, np.array([0.0, 0.0, 0.15]))
            self.ee = self.arm.fk(self.joints)
        else:
            self.ee = np.array([0.0, 0.0, 0.15])
        colors = colors or list(COLOR_MAP)
        shapes = shapes or SHAPE_IDS
        used = []
        for _ in range(num_objects):
            while True:
                color = colors[self.rng.integers(len(colors))]
                shape = shapes[self.rng.integers(len(shapes))]
                if (color, shape) not in used:
                    used.append((color, shape))
                    break
            pos = np.array([self.rng.uniform(-0.22, 0.22),
                            self.rng.uniform(-0.22, 0.22), 0.02])
            self.objects.append(SceneObject(shape, color, pos))

    def sample_target(self) -> np.ndarray:
        """Goal marker for goal-conditioned tasks (Slide)."""
        self.target = np.array([self.rng.uniform(-0.25, 0.25),
                                self.rng.uniform(-0.25, 0.25), 0.0])
        return self.target

    # -- dynamics ------------------------------------------------------------------

    def step(self, action: np.ndarray) -> None:
        """action = (dx, dy, dz, gripper_cmd in [-1, 1])."""
        delta = np.clip(np.asarray(action[:3], np.float64),
                        -MAX_STEP, MAX_STEP)
        target_ee = np.clip(self.ee + delta,
                            WORKSPACE[:, 0], WORKSPACE[:, 1])
        prev_ee = self.ee.copy()
        if self.use_arm:
            self.joints = self.arm.ik(self.joints, target_ee)
            self.ee = self.arm.fk(self.joints)
        else:
            self.ee = target_ee
        self._post_motion(float(action[3]), self.ee - prev_ee)

    def joint_step(self, action: np.ndarray) -> None:
        """``relative_joints`` mode (reference panda.py:23): action = 7 joint
        deltas + gripper command, all in [-1, 1]."""
        assert self.use_arm, "joint_step requires use_arm=True"
        dq = np.clip(np.asarray(action[:NUM_DOF], np.float64), -1, 1) \
            * MAX_JOINT_STEP
        self.joints = np.clip(self.joints + dq,
                              JOINT_LIMITS[:, 0], JOINT_LIMITS[:, 1])
        prev_ee = self.ee.copy()
        self.ee = self.arm.fk(self.joints)
        self._post_motion(float(action[NUM_DOF]), self.ee - prev_ee)

    def _post_motion(self, gripper_cmd: float,
                     ee_move: Optional[np.ndarray] = None) -> None:
        """Contact resolution + impulse dynamics (round 3: force-based, not
        scripted displacement — VERDICT r2 item 8).

        The integration scheme per step: (1) EE->object contact resolves
        penetration along the contact normal and transfers the EE velocity's
        normal component as an impulse; (2) pairwise object-object circle
        collisions de-overlap and exchange normal momentum (equal mass,
        restitution); (3) velocities integrate under Coulomb kinetic
        friction (constant deceleration, not exponential decay — glide
        distance is v^2/2a like a real puck); (4) unsupported objects fall.
        """
        self.gripper = float(np.clip((gripper_cmd + 1) / 2, 0.0, 1.0))
        if ee_move is None:
            ee_move = np.zeros(3)
        mu_a = self.friction * MU_ACCEL
        free = [o for o in self.objects if not o.grasped]
        # (1) EE contact: penetration resolution + momentum transfer
        for obj in free:
            gap = obj.pos[:2] - self.ee[:2]
            dist = np.linalg.norm(gap)
            contact = obj.size + 0.015
            if dist < contact and self.ee[2] < 0.08:
                n = gap / (dist + 1e-9)
                obj.pos[:2] = obj.pos[:2] + n * (contact - dist)
                # impulse: the object leaves contact with at least the EE's
                # velocity along the contact normal (quasi-inelastic push)
                v_n = max(float(np.dot(ee_move[:2], n)), 0.0)
                along = float(np.dot(obj.vel, n))
                if v_n > along:
                    obj.vel = obj.vel + (v_n - along) * n
        # (2) integrate velocities under Coulomb friction
        for obj in free:
            if not np.any(obj.vel):
                continue
            obj.pos[:2] = np.clip(obj.pos[:2] + obj.vel,
                                  WORKSPACE[:2, 0], WORKSPACE[:2, 1])
            speed = float(np.linalg.norm(obj.vel))
            if speed <= mu_a:
                obj.vel = np.zeros(2)
            else:
                obj.vel = obj.vel * (1.0 - mu_a / speed)
        # (3) object-object collisions, resolved post-move so no step ends
        # with interpenetration (same-height circles, equal mass)
        for i in range(len(free)):
            for j in range(i + 1, len(free)):
                a, b = free[i], free[j]
                # stacked pairs rest at z-diff == a.size + b.size exactly
                # (see _rest_height), so the exclusion must be inclusive or a
                # completed stack gets shoved apart as a "lateral overlap"
                if abs(a.pos[2] - b.pos[2]) >= a.size + b.size - 1e-6:
                    continue  # stacked, not lateral contact
                gap = b.pos[:2] - a.pos[:2]
                dist = np.linalg.norm(gap)
                overlap = (a.size + b.size) - dist
                if overlap <= 0:
                    continue
                n = gap / (dist + 1e-9)
                a.pos[:2] -= n * overlap / 2
                b.pos[:2] += n * overlap / 2
                closing = float(np.dot(a.vel - b.vel, n))
                if closing > 0:
                    imp = (1.0 + RESTITUTION) / 2.0 * closing
                    a.vel = a.vel - imp * n
                    b.vel = b.vel + imp * n
        # (4) gravity: objects without support fall toward their rest height
        for obj in free:
            rest = self._rest_height(obj)
            if obj.pos[2] > rest + 1e-9:
                obj.pos[2] = max(rest, obj.pos[2] - GRAVITY_STEP)
        # grasp / release / stack
        for obj in self.objects:
            if obj.grasped:
                if self.gripper > 0.6:           # released
                    obj.grasped = False
                    obj.pos = self.ee.copy()
                    obj.pos[2] = self._rest_height(obj)
                else:
                    obj.pos = self.ee.copy()
            elif (self.gripper < 0.4
                  and np.linalg.norm(self.ee - obj.pos) < GRASP_RADIUS):
                obj.grasped = True

    def _rest_height(self, dropped: SceneObject) -> float:
        """Settle a released object: on top of another object if xy-aligned
        (stacking, reference tasks/stack.py), else on the table."""
        base_z = 0.02
        for other in self.objects:
            if other is dropped or other.grasped:
                continue
            if (np.linalg.norm(dropped.pos[:2] - other.pos[:2])
                    < dropped.size + other.size):
                base_z = max(base_z, other.pos[2] + other.size + dropped.size)
        return base_z

    # -- camera ------------------------------------------------------------------

    def _to_px(self, pos: np.ndarray, size: int = 64) -> Tuple[int, int]:
        x = int((pos[0] - WORKSPACE[0, 0]) / (WORKSPACE[0, 1] - WORKSPACE[0, 0])
                * (size - 1))
        y = int((pos[1] - WORKSPACE[1, 0]) / (WORKSPACE[1, 1] - WORKSPACE[1, 0])
                * (size - 1))
        return x, y

    def _to_px_f(self, pos: np.ndarray, size: int) -> Tuple[float, float]:
        """Float-precision pixel coordinates (sub-pixel rendering path)."""
        x = (pos[0] - WORKSPACE[0, 0]) / (WORKSPACE[0, 1] - WORKSPACE[0, 0]) \
            * (size - 1)
        y = (pos[1] - WORKSPACE[1, 0]) / (WORKSPACE[1, 1] - WORKSPACE[1, 0]) \
            * (size - 1)
        return float(x), float(y)

    def render(self, size: int = 64, aa: Optional[bool] = None) -> np.ndarray:
        """Top-down RGB view (reference: front RGB camera images).

        ``aa=True`` (the default for size > 64) draws with sub-pixel
        anti-aliased primitives (cv2 fixed-point ``shift`` coordinates), so
        an object's blob centroid tracks its continuous world position
        instead of snapping to the integer pixel grid.  Round-5 motivation:
        at 64x64 one pixel is ~9.4 mm of workspace and objects rasterize to
        3 px — the integer-grid render quantizes away precisely the
        instance geometry the VILANRO endpoint task needs (measured:
        round-4 supervised endpoint probes plateau ~0.15 m; see
        benchmarks/vilanro_supervised_ceiling.py).  The 64x64 non-AA path
        is kept bit-identical for existing datasets/tests."""
        import cv2
        if aa is None:
            aa = size > 64
        img = np.full((size, size, 3), (120, 110, 100), np.uint8)  # table
        if not aa:
            return self._render_legacy(img, size, cv2)
        SHIFT = 4
        S = 1 << SHIFT

        def fx(v):
            return int(round(v * S))

        if self.target is not None:
            tx, ty = self._to_px_f(self.target, size)
            cv2.circle(img, (fx(tx), fx(ty)), fx(4.0 * size / 64),
                       (250, 250, 250), max(size // 64, 1), cv2.LINE_AA,
                       SHIFT)
        # draw lower objects first so stacks occlude correctly
        for obj in sorted(self.objects, key=lambda o: o.pos[2]):
            x, y = self._to_px_f(obj.pos, size)
            r = max(obj.size / 0.6 * size, 3.0 * size / 64)
            color = COLOR_MAP[obj.color]
            if obj.shape == "cube":
                cv2.rectangle(img, (fx(x - r), fx(y - r)),
                              (fx(x + r), fx(y + r)), color, -1,
                              cv2.LINE_AA, SHIFT)
            elif obj.shape == "cylinder":
                cv2.circle(img, (fx(x), fx(y)), fx(r), color, -1,
                           cv2.LINE_AA, SHIFT)
            else:  # sphere: circle + highlight
                cv2.circle(img, (fx(x), fx(y)), fx(r), color, -1,
                           cv2.LINE_AA, SHIFT)
                cv2.circle(img, (fx(x - r / 3), fx(y - r / 3)),
                           fx(max(r / 3, 1.0)), (255, 255, 255), -1,
                           cv2.LINE_AA, SHIFT)
        ex, ey = self._to_px_f(self.ee, size)
        arm = 4.5 * size / 64
        thick = max(int(round(2 * size / 64)), 1)
        cv2.line(img, (fx(ex - arm), fx(ey)), (fx(ex + arm), fx(ey)),
                 (20, 20, 20), thick, cv2.LINE_AA, SHIFT)
        cv2.line(img, (fx(ex), fx(ey - arm)), (fx(ex), fx(ey + arm)),
                 (20, 20, 20), thick, cv2.LINE_AA, SHIFT)
        return img

    def _render_legacy(self, img: np.ndarray, size: int, cv2) -> np.ndarray:
        """Integer-grid rasterizer — the original (round 1-4) render path,
        kept bit-identical so existing 64x64 datasets stay reproducible."""
        if self.target is not None:
            tx, ty = self._to_px(self.target, size)
            cv2.circle(img, (tx, ty), 4, (250, 250, 250), 1)
        for obj in sorted(self.objects, key=lambda o: o.pos[2]):
            x, y = self._to_px(obj.pos, size)
            r = max(int(obj.size / 0.6 * size), 3)
            color = COLOR_MAP[obj.color]
            if obj.shape == "cube":
                cv2.rectangle(img, (x - r, y - r), (x + r, y + r), color, -1)
            elif obj.shape == "cylinder":
                cv2.circle(img, (x, y), r, color, -1)
            else:  # sphere: circle + highlight
                cv2.circle(img, (x, y), r, color, -1)
                cv2.circle(img, (x - r // 3, y - r // 3), max(r // 3, 1),
                           (255, 255, 255), -1)
        ex, ey = self._to_px(self.ee, size)
        cv2.drawMarker(img, (ex, ey), (20, 20, 20), cv2.MARKER_CROSS, 9, 2)
        return img
