"""7-DoF kinematic arm (joint-space Panda stand-in).

The reference's Panda robot is a PyBullet URDF with 7 arm joints driven in
``relative_joints`` mode (lanro_gym/robots/panda.py:8-52).  PyBullet is not a
dependency, so this is an analytic serial chain with the same control
surface: 7 revolute joints (alternating yaw/pitch like the Panda), forward
kinematics, damped-least-squares inverse kinematics for Cartesian tracking,
joint limits, and a neutral pose.  Dynamics (masses/forces) are out of scope
— the tasks' success predicates are positional.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# (rotation axis in parent frame, link vector in the joint's local frame)
CHAIN: List[Tuple[str, Sequence[float]]] = [
    ("z", (0.0, 0.0, 0.16)),   # base yaw + shoulder riser
    ("y", (0.0, 0.0, 0.32)),   # shoulder pitch + upper arm
    ("z", (0.0, 0.0, 0.0)),    # upper-arm roll
    ("y", (0.0, 0.0, 0.32)),   # elbow pitch + forearm
    ("z", (0.0, 0.0, 0.0)),    # forearm roll
    ("y", (0.0, 0.0, 0.20)),   # wrist pitch + hand
    ("z", (0.0, 0.0, 0.06)),   # wrist yaw + gripper mount
]
NUM_DOF = len(CHAIN)
JOINT_LIMITS = np.array([[-2.9, 2.9]] * NUM_DOF)
# mirrors the spirit of Panda.NEUTRAL_JOINT_VALUES: elbow bent, EE over table
NEUTRAL_JOINT_VALUES = np.array([0.0, 0.6, 0.0, -1.6, 0.0, 1.1, 0.0])
BASE_POSITION = np.array([-0.42, 0.0, 0.0])


def _rot(axis: str, q: float) -> np.ndarray:
    c, s = np.cos(q), np.sin(q)
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1.0, 0], [-s, 0, c]])
    return np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])


class ArmKinematics:
    """Stateless FK/IK over the 7-joint chain."""

    def __init__(self, base_position: np.ndarray = BASE_POSITION):
        self.base = np.asarray(base_position, np.float64)

    def fk(self, q: np.ndarray) -> np.ndarray:
        """End-effector position for joint vector q (radians)."""
        p = self.base.copy()
        R = np.eye(3)
        for (axis, link), qi in zip(CHAIN, q):
            R = R @ _rot(axis, float(qi))
            p = p + R @ np.asarray(link, np.float64)
        return p

    def jacobian(self, q: np.ndarray, eps: float = 1e-5) -> np.ndarray:
        """Numerical position Jacobian (3 x 7)."""
        J = np.zeros((3, NUM_DOF))
        f0 = self.fk(q)
        for i in range(NUM_DOF):
            dq = q.copy()
            dq[i] += eps
            J[:, i] = (self.fk(dq) - f0) / eps
        return J

    def ik(self, q: np.ndarray, target: np.ndarray, iters: int = 30,
           damping: float = 0.02, tol: float = 1e-4) -> np.ndarray:
        """Damped-least-squares IK toward a Cartesian target."""
        q = np.clip(np.asarray(q, np.float64).copy(),
                    JOINT_LIMITS[:, 0], JOINT_LIMITS[:, 1])
        lam2 = damping * damping
        for _ in range(iters):
            err = np.asarray(target, np.float64) - self.fk(q)
            if np.linalg.norm(err) < tol:
                break
            J = self.jacobian(q)
            JJt = J @ J.T + lam2 * np.eye(3)
            q = q + J.T @ np.linalg.solve(JJt, err)
            q = np.clip(q, JOINT_LIMITS[:, 0], JOINT_LIMITS[:, 1])
        return q
