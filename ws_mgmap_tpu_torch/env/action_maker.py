"""Waypoint -> low-level discrete action conversion.

Re-provides `ActionMaker`/`GTMapActionMaker`/`DDPPOActionMaker`
(`vlnce_baselines/common/action_maker.py:9-124`): the policy regresses a
normalized egocentric waypoint; the action maker converts it to world
coordinates and picks the next discrete sim action, either with the oracle
geodesic follower (rollout collection) or the frozen DD-PPO PointNav local
controller (evaluation).

The port's copy of ``ws_mgmap_tpu/env/action_maker.py``.
"""
from __future__ import annotations

import math

import numpy as np

from ws_mgmap_tpu_torch.env.sensors import COORDINATE_MAX, COORDINATE_MIN, greedy_follower_action
from ws_mgmap_tpu_torch.utils.geometry import AgentState, TransformationRealworldAgent


class ActionMaker:
    """`action_maker.py:9-31`: tanh-normalized ego waypoint -> world point."""

    MAP_SIZE = 1250  # habitat top-down map resolution (`action_maker.py:15`)

    def __init__(self, ego_map_size: int = 100):
        self.ego_map_size = ego_map_size
        self.resolution = (COORDINATE_MAX - COORDINATE_MIN) / self.MAP_SIZE

    def preprocess(self, action: np.ndarray, agent_state: AgentState) -> np.ndarray:
        wp = np.tanh(np.asarray(action, np.float64))
        wp_agent = np.zeros(3)
        wp_agent[0] = wp[0] * (self.ego_map_size / 2) * self.resolution
        wp_agent[2] = -wp[1] * (self.ego_map_size / 2) * self.resolution
        return TransformationRealworldAgent(agent_state).agent2realworld(wp_agent)


class GTMapActionMaker(ActionMaker):
    """`action_maker.py:34-44`: oracle shortest-path follower toward the
    predicted waypoint (used during DAgger collection)."""

    def action_decision(self, sim, waypoint: np.ndarray) -> int:
        action = greedy_follower_action(sim, waypoint, goal_radius=0.5)
        # follower-None (within 0.5 m of the WAYPOINT) -> MOVE_FORWARD
        # (`action_maker.py:41-44`): only decide_stop/prog may end the
        # episode, never waypoint arrival.
        return 1 if action is None else action


class DDPPOActionMaker(ActionMaker):
    """`action_maker.py:47-124`: frozen DD-PPO PointNav policy as the local
    controller. Maintains the absolute pose trace, converts the waypoint to
    (rho, phi) in the agent frame and queries the controller.

    The heavy geometry of the reference (512^2 5-cm global grid round trip,
    `transform_waypoint2cm2`:91) exists to re-derive (rho, phi) from grid
    coords; we compute the same polar goal directly from the pose trace.
    """

    cell_size = 0.05

    def __init__(self, ego_map_size: int = 100, controller=None):
        super().__init__(ego_map_size)
        self.controller = controller  # models/ddppo_policy adapter
        self.reset()

    def reset(self):
        if self.controller is not None:
            self.controller.reset()

    def action_decision(self, sim, waypoint: np.ndarray, depth_img,
                        t: int) -> int:
        ag = sim.get_agent_state()
        if self.controller is None:
            return GTMapActionMaker(self.ego_map_size).action_decision(sim, waypoint)
        # (rho, phi) of the waypoint in the agent frame, matching the
        # pointgoal_with_gps_compass convention (`ddppo_policy.py:57-77`).
        rel = TransformationRealworldAgent(ag).realworld2agent(waypoint)
        rho = math.hypot(rel[0], rel[2])
        # habitat pointgoal_with_gps_compass polar convention:
        # phi = atan2(x_agent, -z_agent)
        phi = math.atan2(rel[0], -rel[2])
        # quantize rho to the reference's 5-cm grid resolution
        rho = round(rho / self.cell_size) * self.cell_size
        return int(self.controller.plan(depth_img, np.array([rho, phi]), t))
