"""Evaluation measures (host-side, per-episode).

Re-provides the reference's metric suite: the custom measures in
`habitat_extensions/measures.py` (PathLength:14, OracleNavigationError:62,
OracleSuccess:94, OracleSPL:130, StepsTaken:184, NDTW:210, SDTW:265) plus
the habitat-lab built-ins the task config enables
(`vlnce_task.yaml:38-46`): DISTANCE_TO_GOAL, SUCCESS, SPL.

DTW note: the reference uses `fastdtw` (approximate, radius 1); we compute
*exact* DTW (O(n*m) is trivial at episode scale), which is the quantity the
nDTW paper defines. Exact DTW distance <= fastdtw distance, so nDTW here is
a (tight) upper bound of the reference's number.

The port's copy of ``ws_mgmap_tpu/env/measures.py``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np


def _euclid(a, b) -> float:
    return float(np.linalg.norm(np.asarray(b) - np.asarray(a)))


def dtw_distance(seq_a: List, seq_b: List) -> float:
    """Exact DTW with euclidean point distance."""
    n, m = len(seq_a), len(seq_b)
    a = np.asarray(seq_a, np.float64)
    b = np.asarray(seq_b, np.float64)
    # pairwise distances [n, m]
    d = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        acc[i, 1:] = d[i - 1]
        for j in range(1, m + 1):
            acc[i, j] += min(acc[i - 1, j], acc[i, j - 1], acc[i - 1, j - 1])
    return float(acc[n, m])


class Measure:
    uuid = "measure"

    def reset_metric(self, sim, episode):
        raise NotImplementedError

    def update_metric(self, sim, episode, action, stop_called: bool):
        raise NotImplementedError

    def get_metric(self):
        return self._metric


class DistanceToGoal(Measure):
    uuid = "distance_to_goal"

    def reset_metric(self, sim, episode):
        self.update_metric(sim, episode, None, False)

    def update_metric(self, sim, episode, action, stop_called):
        self._metric = sim.geodesic_distance(
            sim.get_agent_state().position, episode.goals[0]["position"])


class Success(Measure):
    uuid = "success"

    def __init__(self, success_distance: float = 3.0):
        self.success_distance = success_distance

    def reset_metric(self, sim, episode):
        self._metric = 0.0

    def update_metric(self, sim, episode, action, stop_called):
        d = sim.geodesic_distance(
            sim.get_agent_state().position, episode.goals[0]["position"])
        self._metric = float(stop_called and d < self.success_distance)


class SPL(Measure):
    """Success weighted by path length (habitat-lab measure, enabled at
    `vlnce_task.yaml:49-50`)."""

    uuid = "spl"

    def __init__(self, success_distance: float = 3.0):
        self.success_distance = success_distance

    def reset_metric(self, sim, episode):
        self._prev = sim.get_agent_state().position.copy()
        self._start_dist = sim.geodesic_distance(
            self._prev, episode.goals[0]["position"])
        self._agent_dist = 0.0
        self._metric = 0.0

    def update_metric(self, sim, episode, action, stop_called):
        cur = sim.get_agent_state().position
        self._agent_dist += _euclid(cur, self._prev)
        self._prev = cur.copy()
        d = sim.geodesic_distance(cur, episode.goals[0]["position"])
        success = float(stop_called and d < self.success_distance)
        self._metric = success * self._start_dist / max(
            self._start_dist, self._agent_dist, 1e-8)


class PathLength(Measure):
    """`measures.py:14-59`."""

    uuid = "path_length"

    def reset_metric(self, sim, episode):
        self._prev = sim.get_agent_state().position.copy()
        self._metric = 0.0

    def update_metric(self, sim, episode, action, stop_called):
        cur = sim.get_agent_state().position
        self._metric += _euclid(cur, self._prev)
        self._prev = cur.copy()


class OracleNavigationError(Measure):
    """`measures.py:62-91`."""

    uuid = "oracle_navigation_error"

    def reset_metric(self, sim, episode):
        self._metric = float("inf")
        self.update_metric(sim, episode, None, False)

    def update_metric(self, sim, episode, action, stop_called):
        d = sim.geodesic_distance(
            sim.get_agent_state().position, episode.goals[0]["position"])
        self._metric = min(self._metric, d)


class OracleSuccess(Measure):
    """`measures.py:94-127`."""

    uuid = "oracle_success"

    def __init__(self, success_distance: float = 3.0):
        self.success_distance = success_distance

    def reset_metric(self, sim, episode):
        self._metric = 0.0

    def update_metric(self, sim, episode, action, stop_called):
        if self._metric:
            return
        d = sim.geodesic_distance(
            sim.get_agent_state().position, episode.goals[0]["position"])
        if d < self.success_distance:
            self._metric = 1.0


class OracleSPL(Measure):
    """`measures.py:130-181`."""

    uuid = "oracle_spl"

    def __init__(self, success_distance: float = 3.0):
        self.success_distance = success_distance

    def reset_metric(self, sim, episode):
        self._prev = sim.get_agent_state().position.copy()
        self._start_dist = episode.info["geodesic_distance"]
        self._agent_dist = 0.0
        self._success = 0
        self._metric = 0.0

    def update_metric(self, sim, episode, action, stop_called):
        if self._success:
            return
        cur = sim.get_agent_state().position
        self._agent_dist += _euclid(cur, self._prev)
        self._prev = cur.copy()
        d = sim.geodesic_distance(cur, episode.goals[0]["position"])
        if d < self.success_distance:
            self._success = 1
            self._metric = self._start_dist / max(
                self._start_dist, self._agent_dist, 1e-8)


class StepsTaken(Measure):
    """`measures.py:184-207`."""

    uuid = "steps_taken"

    def reset_metric(self, sim, episode):
        self._metric = 0.0

    def update_metric(self, sim, episode, action, stop_called):
        self._metric += 1.0


class NDTW(Measure):
    """`measures.py:210-262` with exact DTW (see module docstring)."""

    uuid = "ndtw"

    def __init__(self, gt_locations: Dict[str, Any],
                 success_distance: float = 3.0):
        self.gt_json = gt_locations
        self.success_distance = success_distance

    def reset_metric(self, sim, episode):
        self.locations: List[List[float]] = []
        self.gt_locations = self.gt_json.get(
            str(episode.episode_id), {}).get("locations", [])
        if not self.gt_locations and episode.reference_path:
            self.gt_locations = episode.reference_path
        self._metric = 0.0
        self.update_metric(sim, episode, None, False)

    def update_metric(self, sim, episode, action, stop_called):
        if not self.gt_locations:
            return
        cur = sim.get_agent_state().position.tolist()
        if not self.locations or cur != self.locations[-1]:
            self.locations.append(cur)
        dist = dtw_distance(self.locations, self.gt_locations)
        self._metric = math.exp(
            -dist / (len(self.gt_locations) * self.success_distance))


class SDTW(NDTW):
    """`measures.py:265-325`."""

    uuid = "sdtw"

    def update_metric(self, sim, episode, action, stop_called):
        super().update_metric(sim, episode, action, stop_called)
        d = sim.geodesic_distance(
            sim.get_agent_state().position, episode.goals[0]["position"])
        success = stop_called and d < self.success_distance
        self._metric = self._metric * float(success)


class Collisions(Measure):
    """habitat-lab Collisions measure (enabled for eval videos at
    `common_trainer.py:277`): {count, is_collision}."""

    uuid = "collisions"

    def reset_metric(self, sim, episode):
        self._metric = {"count": 0, "is_collision": False}

    def update_metric(self, sim, episode, action, stop_called):
        collided = bool(getattr(sim, "last_collided", False))
        self._metric = {
            "count": self._metric["count"] + int(collided),
            "is_collision": collided,
        }


def default_measures(gt_locations: Dict[str, Any],
                     success_distance: float = 3.0) -> List[Measure]:
    """The suite enabled by `vlnce_task.yaml:38-46` (+ oracle extras)."""
    return [
        DistanceToGoal(),
        Success(success_distance),
        SPL(success_distance),
        NDTW(gt_locations, success_distance),
        PathLength(),
        OracleSuccess(success_distance),
        OracleNavigationError(),
        OracleSPL(success_distance),
        StepsTaken(),
        SDTW(gt_locations, success_distance),
    ]
