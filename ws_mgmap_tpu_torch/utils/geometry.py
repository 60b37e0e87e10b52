"""Host-side pose math (numpy): quaternions, frames, heading.

Replaces the `quaternion` package + habitat geometry utils used by the
reference (`common/utils.py:110-122,241-261`, `sensors.py:436-449`,
`environments.py:105-109`). Quaternions are [w, x, y, z] scalar-first.
Habitat conventions: +y up, agent forward is -z, yaw rotates about +y.

The port's copy of ``ws_mgmap_tpu/utils/geometry.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np


def quat_from_yaw(yaw: float) -> np.ndarray:
    """Rotation about +y by yaw (habitat agent rotation)."""
    return np.array([math.cos(yaw / 2.0), 0.0, math.sin(yaw / 2.0), 0.0])


def quat_from_coeffs(coeffs: Sequence[float]) -> np.ndarray:
    """habitat datasets store [x, y, z, w]; return [w, x, y, z]."""
    x, y, z, w = coeffs
    return np.array([w, x, y, z], dtype=np.float64)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_inverse(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    return np.array([w, -x, -y, -z]) / n


def quat_rotate_vector(q: np.ndarray, v: Sequence[float]) -> np.ndarray:
    """Rotate 3-vector v by quaternion q."""
    vq = np.array([0.0, *v])
    return quat_mul(quat_mul(q, vq), quat_inverse(q))[1:]


def quat_to_rotation_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def cartesian_to_polar(x: float, y: float) -> Tuple[float, float]:
    return math.hypot(x, y), math.atan2(y, x)


def heading_from_quaternion(q: np.ndarray) -> float:
    """habitat heading: angle of the agent's forward (-z) in the x/z plane.

    Matches `HeadingSensor._quat_to_xy_heading` (`sensors.py:436-440`) which
    is applied to ``rotation.inverse()`` by its caller.
    """
    direction = quat_rotate_vector(q, np.array([0.0, 0.0, -1.0]))
    return cartesian_to_polar(-direction[2], direction[0])[1]


def yaw_from_quaternion(q: np.ndarray) -> float:
    """Yaw about +y for a pure-yaw quaternion."""
    return 2.0 * math.atan2(q[2], q[0])


@dataclasses.dataclass
class AgentState:
    position: np.ndarray  # [3] world (x, y, z)
    rotation: np.ndarray  # quaternion [w, x, y, z]


class TransformationRealworldAgent:
    """world <-> agent frame (`common/utils.py:241-261`)."""

    def __init__(self, agent_state: AgentState):
        self.t = np.asarray(agent_state.position, np.float64).reshape(3, 1)
        self.r = quat_to_rotation_matrix(np.asarray(agent_state.rotation))

    def realworld2agent(self, point: Sequence[float]) -> np.ndarray:
        p = np.asarray(point, np.float64).reshape(3, 1)
        return np.asarray(self.r.T @ p + self.r.T @ (-self.t)).ravel()

    def agent2realworld(self, point: Sequence[float]) -> np.ndarray:
        p = np.asarray(point, np.float64).reshape(3, 1)
        return np.asarray(self.r @ p + self.t).ravel()


def get_sim_location(agent_state: AgentState) -> Tuple[Tuple[float, float, float], float]:
    """(x, y, yaw) pose in the DD-PPO controller's 2-D convention + height
    (`common/utils.py:110-122`)."""
    x = -float(agent_state.position[2])
    y = -float(agent_state.position[0])
    height = float(agent_state.position[1])
    o = yaw_from_quaternion(np.asarray(agent_state.rotation))
    o = (o + math.pi) % (2 * math.pi) - math.pi
    return (x, y, o), height
