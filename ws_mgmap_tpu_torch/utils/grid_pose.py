"""Pose <-> global-grid bookkeeping for the DD-PPO local controller.

Re-provides the `SemanticGrid`/`utils` geometry of the reference
(`vlnce_baselines/models/ddppo_policy.py:84-288`): relative poses, 5-cm
grid discretization, waypoint/agent coordinates in the controller's
512x512 geocentric grid, and ego->geo transforms. The controller adapter
(env/action_maker.py) computes (rho, phi) directly, but these helpers keep
the full grid-coordinate surface available (visualization, debugging,
alternative local planners).

The port's copy of ``ws_mgmap_tpu/utils/grid_pose.py``. ``get_coord_pose``
bins with Python's ``round`` on float64 (ties to even), as the JAX package
does.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from ws_mgmap_tpu_torch.utils.geometry import AgentState, get_sim_location


def get_rel_pose(pos2: Sequence[float], pos1: Sequence[float]):
    """`utils.get_rel_pose` (`ddppo_policy.py:176-192`)."""
    x1, y1, o1 = pos1
    if len(pos2) == 2:
        return pos2[0] - x1, pos2[1] - y1
    x2, y2, o2 = pos2
    do = o2 - o1
    if do < -math.pi:
        do += 2 * math.pi
    if do > math.pi:
        do -= 2 * math.pi
    return x2 - x1, y2 - y1, do


def discretize_coords(x: np.ndarray, z: np.ndarray, grid_dim: Tuple[int, int],
                      cell_size: float, translation: float = 0.0) -> np.ndarray:
    """`utils.discretize_coords` (`ddppo_policy.py:194-205`)."""
    xb = np.floor(np.asarray(x) / cell_size) + (grid_dim[0] - 1) / 2.0
    zb = np.floor(np.asarray(z) / cell_size) + (grid_dim[1] - 1) / 2.0 + translation
    coords = np.stack([xb, zb], axis=-1)
    return np.clip(coords, 0, grid_dim[0] - 1).astype(np.int64)


def unravel_index(indices: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """`utils.unravel_index` (`ddppo_policy.py:221-239`)."""
    return np.stack(np.unravel_index(np.asarray(indices) % int(np.prod(shape)),
                                     shape), axis=-1)


def get_coord_pose(rel_pose: Sequence[float], init_pose: Sequence[float],
                   grid_dim: int, cell_size: float) -> np.ndarray:
    """Agent/waypoint position in the geocentric grid
    (`utils.get_coord_pose` + `SemanticGrid.spatialTransformer`,
    `ddppo_policy.py:98-125,241-268`): rotate the relative displacement by
    the episode-initial heading and bin at ``cell_size`` around center."""
    o0 = init_pose[2]
    rot = np.array([[math.cos(o0), -math.sin(o0)],
                    [math.sin(o0), math.cos(o0)]])
    rel = rot @ np.array([rel_pose[1], rel_pose[0]], np.float64)
    center = grid_dim // 2 - 1
    r = round(-rel[1] / cell_size + center)
    c = round(-rel[0] / cell_size + center)
    return np.array([[int(np.clip(c, 0, grid_dim - 1)),
                      int(np.clip(r, 0, grid_dim - 1))]], np.int64)


def transform_ego_to_geo(ego_point, pose_coords, abs_pose_coords,
                         abs_poses, t: int) -> np.ndarray:
    """`utils.transform_ego_to_geo` (`ddppo_policy.py:270-288`)."""
    rel_rot = abs_poses[0][2] - abs_poses[t][2]
    dist = np.array([ego_point[0] - pose_coords[0],
                     ego_point[1] - pose_coords[1]], np.float64)
    rot = np.array([[math.cos(rel_rot), -math.sin(rel_rot)],
                    [math.sin(rel_rot), math.cos(rel_rot)]])
    vec = rot @ dist
    return np.array([abs_pose_coords[0] + vec[0],
                     abs_pose_coords[1] + vec[1]])


class PoseTrace:
    """Absolute-pose trace kept by the DD-PPO action maker
    (`action_maker.py:91-112`): records (x, y, yaw) per step and answers
    grid-coordinate queries against the episode-initial frame."""

    def __init__(self, grid_dim: int = 512, cell_size: float = 0.05):
        self.grid_dim = grid_dim
        self.cell_size = cell_size
        self.abs_poses = []
        self.heights = []

    def reset(self):
        self.abs_poses = []
        self.heights = []

    def append(self, agent_state: AgentState):
        pose, height = get_sim_location(agent_state)
        self.abs_poses.append(pose)
        self.heights.append(height)
        return pose

    def agent_grid_coords(self, t: int) -> np.ndarray:
        rel = get_rel_pose(self.abs_poses[t], self.abs_poses[0])
        return get_coord_pose(rel, self.abs_poses[0], self.grid_dim,
                              self.cell_size)

    def waypoint_grid_coords(self, waypoint_world, t: int) -> np.ndarray:
        wp = [-waypoint_world[2], -waypoint_world[0], self.abs_poses[t][2]]
        rel = get_rel_pose(wp, self.abs_poses[0])
        return get_coord_pose(rel, self.abs_poses[0], self.grid_dim,
                              self.cell_size)
