"""Simulator backend protocol + a deterministic FakeSim.

The port's copy of ``ws_mgmap_tpu/env/sim.py``. The reference drives
habitat-sim (C++) through `habitat.Env` (`SETUP.md:24-44`; SURVEY §2.4).
This framework talks to a small `SimBackend` protocol instead; the
Habitat adapter (``env/habitat_backend.py``, the port's copy of the JAX
package's) maps it onto habitat-sim, and :class:`FakeSim` provides a
fully deterministic grid-world (occupancy + semantics + ray-cast RGB-D) so every trainer/env
component is testable and benchmarkable without Matterport3D assets.

Conventions follow habitat: +y up, forward = -z, TURN_LEFT = +15 deg yaw,
FORWARD = 0.25 m (`habitat_extensions/config/vlnce_task.yaml:6-7`). Actions:
0 STOP, 1 MOVE_FORWARD, 2 TURN_LEFT, 3 TURN_RIGHT.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Tuple

import numpy as np

from ws_mgmap_tpu_torch.utils.geometry import (
    AgentState,
    quat_from_yaw,
    yaw_from_quaternion,
)

STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2, 3

_SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass
class FakeSceneSpec:
    extent_m: float = 16.0
    cell_m: float = 0.1
    num_boxes: int = 10
    num_classes: int = 27


class FakeScene:
    """Deterministic occupancy + semantic grid derived from the scene id."""

    def __init__(self, scene_id: str, spec: FakeSceneSpec = FakeSceneSpec()):
        self.scene_id = scene_id
        self.spec = spec
        n = int(round(spec.extent_m / spec.cell_m))
        self.n = n
        # zlib.crc32: stable across processes (builtin hash() is randomized
        # per interpreter, which would desync env workers from the dataset)
        import zlib
        seed = zlib.crc32(f"fake-scene/{scene_id}".encode()) % (2 ** 31)
        rng = np.random.RandomState(seed)
        occ = np.zeros((n, n), bool)
        occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
        sem = np.zeros((n, n), np.int8)
        sem[occ] = 1  # walls
        for _ in range(spec.num_boxes):
            h = rng.randint(4, n // 6)
            w = rng.randint(4, n // 6)
            r = rng.randint(2, n - h - 2)
            c = rng.randint(2, n - w - 2)
            # keep the center area clear so episodes always have free space
            if abs(r + h / 2 - n / 2) < n // 8 and abs(c + w / 2 - n / 2) < n // 8:
                continue
            occ[r:r + h, c:c + w] = True
            sem[r:r + h, c:c + w] = rng.randint(2, spec.num_classes)
        self.occ = occ
        self.sem = sem
        self._dist_fields: Dict[Tuple[int, int], np.ndarray] = {}

    # -- coords ------------------------------------------------------------
    def world_to_cell(self, p) -> Tuple[int, int]:
        half = self.spec.extent_m / 2.0
        col = int((p[0] + half) / self.spec.cell_m)
        row = int((p[2] + half) / self.spec.cell_m)
        return (
            min(max(row, 0), self.n - 1),
            min(max(col, 0), self.n - 1),
        )

    def cell_to_world(self, rc: Tuple[int, int], y: float = 0.0) -> np.ndarray:
        half = self.spec.extent_m / 2.0
        x = (rc[1] + 0.5) * self.spec.cell_m - half
        z = (rc[0] + 0.5) * self.spec.cell_m - half
        return np.array([x, y, z])

    def navigable(self, p) -> bool:
        return not self.occ[self.world_to_cell(p)]

    def sample_navigable(self, rng: np.random.RandomState) -> np.ndarray:
        free = np.argwhere(~self.occ)
        rc = free[rng.randint(len(free))]
        return self.cell_to_world((int(rc[0]), int(rc[1])))

    # -- planning ----------------------------------------------------------
    def distance_field(self, goal_rc: Tuple[int, int]) -> np.ndarray:
        """Dijkstra flood from the goal cell (8-connected)."""
        if goal_rc in self._dist_fields:
            return self._dist_fields[goal_rc]
        n = self.n
        dist = np.full((n, n), np.inf, np.float64)
        if self.occ[goal_rc]:
            self._dist_fields[goal_rc] = dist
            return dist
        dist[goal_rc] = 0.0
        pq = [(0.0, goal_rc)]
        nbrs = [(-1, 0, 1.0), (1, 0, 1.0), (0, -1, 1.0), (0, 1, 1.0),
                (-1, -1, _SQRT2), (-1, 1, _SQRT2), (1, -1, _SQRT2), (1, 1, _SQRT2)]
        occ = self.occ
        while pq:
            d, (r, c) = heapq.heappop(pq)
            if d > dist[r, c]:
                continue
            for dr, dc, w in nbrs:
                rr, cc = r + dr, c + dc
                if 0 <= rr < n and 0 <= cc < n and not occ[rr, cc]:
                    nd = d + w
                    if nd < dist[rr, cc]:
                        dist[rr, cc] = nd
                        heapq.heappush(pq, (nd, (rr, cc)))
        self._dist_fields[goal_rc] = dist
        return dist

    def geodesic_distance(self, a, b) -> float:
        field = self.distance_field(self.world_to_cell(b))
        d = field[self.world_to_cell(a)]
        return float(d * self.spec.cell_m) if np.isfinite(d) else math.inf

    def shortest_path_points(self, a, b) -> List[np.ndarray]:
        """Greedy descent on the goal's distance field; world waypoints."""
        goal_rc = self.world_to_cell(b)
        field = self.distance_field(goal_rc)
        rc = self.world_to_cell(a)
        if not np.isfinite(field[rc]):
            return []
        path = [rc]
        nbrs = [(-1, 0), (1, 0), (0, -1), (0, 1),
                (-1, -1), (-1, 1), (1, -1), (1, 1)]
        while rc != goal_rc and len(path) < self.n * self.n:
            best, best_d = rc, field[rc]
            for dr, dc in nbrs:
                rr, cc = rc[0] + dr, rc[1] + dc
                if 0 <= rr < self.n and 0 <= cc < self.n and field[rr, cc] < best_d:
                    best, best_d = (rr, cc), field[rr, cc]
            if best == rc:
                break
            rc = best
            path.append(rc)
        pts = [self.cell_to_world(rc) for rc in path]
        # collinear simplification
        out = [pts[0]]
        for i in range(1, len(pts) - 1):
            v0 = pts[i] - out[-1]
            v1 = pts[i + 1] - pts[i]
            if abs(v0[0] * v1[2] - v0[2] * v1[0]) > 1e-9:
                out.append(pts[i])
        out.append(pts[-1])
        return out


_SCENE_CACHE: Dict[str, FakeScene] = {}


def get_scene(scene_id: str) -> FakeScene:
    if scene_id not in _SCENE_CACHE:
        _SCENE_CACHE[scene_id] = FakeScene(scene_id)
    return _SCENE_CACHE[scene_id]


class FakeSim:
    """Deterministic simulator over a :class:`FakeScene`.

    Implements the SimBackend surface consumed by the task layer: agent
    state, discrete stepping, geodesic queries, RGB-D(+semantic) rendering.
    """

    forward_step = 0.25
    turn_angle_deg = 15.0

    def __init__(self, scene_id: str, rgb_hw: Tuple[int, int] = (224, 224),
                 depth_hw: Tuple[int, int] = (256, 256), max_depth_m: float = 10.0):
        self.scene = get_scene(scene_id)
        self.rgb_hw = rgb_hw
        self.depth_hw = depth_hw
        self.max_depth_m = max_depth_m
        self._pos = np.zeros(3)
        self._yaw = 0.0
        self.record_heading = 0.0  # HeadingSensor side channel (`sensors.py:449`)
        self.last_collided = False  # feeds the Collisions measure
        self._goal: np.ndarray | None = None  # visible goal beacon (optional)

    def set_goal(self, position) -> None:
        """Place a visible goal beacon for the current episode.

        Matterport scenes make goals *describable* ("the red armchair");
        FakeSim's procedural boxes don't, so without this the oracle
        waypoint is unlearnable from observations (the policy can only
        regress "straight ahead"). The beacon renders the goal as a
        distinct semantic column (label 26) in RGB-D whenever it is in
        line of sight, so its features splat into the ego map at the true
        goal cell — the spatial signal the multi-granularity map method
        (`rgb_mapping.py:79-90`) is designed to exploit. Test-infrastructure
        only; the Habitat backend has no such method."""
        self._goal = np.asarray(position, np.float64).copy()

    # -- state ---------------------------------------------------------------
    def reset_agent(self, position, rotation) -> None:
        self._pos = np.asarray(position, np.float64).copy()
        self._yaw = yaw_from_quaternion(np.asarray(rotation, np.float64))

    def get_agent_state(self) -> AgentState:
        return AgentState(self._pos.copy(), quat_from_yaw(self._yaw))

    def forward_vector(self) -> np.ndarray:
        return np.array([-math.sin(self._yaw), 0.0, -math.cos(self._yaw)])

    def step(self, action: int) -> None:
        self.last_collided = False
        if action == MOVE_FORWARD:
            target = self._pos + self.forward_step * self.forward_vector()
            # segment collision check at half-cell resolution
            steps = 6
            ok = True
            for i in range(1, steps + 1):
                p = self._pos + (target - self._pos) * (i / steps)
                if not self.scene.navigable(p):
                    ok = False
                    break
            if ok:
                self._pos = target
            else:
                self.last_collided = True
        elif action == TURN_LEFT:
            self._yaw += math.radians(self.turn_angle_deg)
        elif action == TURN_RIGHT:
            self._yaw -= math.radians(self.turn_angle_deg)
        self._yaw = (self._yaw + math.pi) % (2 * math.pi) - math.pi

    # -- queries ---------------------------------------------------------------
    def geodesic_distance(self, a, b) -> float:
        return self.scene.geodesic_distance(a, b)

    def get_straight_shortest_path_points(self, a, b) -> List[np.ndarray]:
        return self.scene.shortest_path_points(a, b)

    def is_navigable(self, p) -> bool:
        return self.scene.navigable(p)

    def semantic_annotations(self):
        return self.scene

    # -- rendering ---------------------------------------------------------------
    def _raycast(self, n_cols: int, fov_deg: float = 90.0):
        """Vectorized 2-D ray march: per-column (z-depth m, semantic label).

        All columns advance together in numpy; first blocked cell along each
        ray wins (argmax over the hit mask).
        """
        f = (n_cols / 2.0) / math.tan(math.radians(fov_deg / 2.0))
        cols = np.arange(n_cols) + 0.5 - n_cols / 2.0
        alphas = np.arctan(cols / f)
        ang = self._yaw - alphas  # camera x axis is to the right
        dir_x = -np.sin(ang)
        dir_z = -np.cos(ang)

        scene = self.scene
        cell = scene.spec.cell_m
        half = scene.spec.extent_m / 2.0
        step = cell * 0.5
        radii = (np.arange(1, int(self.max_depth_m / step) + 1) * step)

        # sample points [n_steps, n_cols]
        px = self._pos[0] + radii[:, None] * dir_x[None, :]
        pz = self._pos[2] + radii[:, None] * dir_z[None, :]
        rows = np.clip(((pz + half) / cell).astype(np.int64), 0, scene.n - 1)
        colz = np.clip(((px + half) / cell).astype(np.int64), 0, scene.n - 1)
        blocked = scene.occ[rows, colz]  # [n_steps, n_cols]

        any_hit = blocked.any(axis=0)
        first = np.argmax(blocked, axis=0)  # 0 when no hit; masked below
        hit_r = np.where(any_hit, radii[first], self.max_depth_m)
        labels = np.where(
            any_hit,
            scene.sem[rows[first, np.arange(n_cols)],
                      colz[first, np.arange(n_cols)]],
            0,
        ).astype(np.int32)
        if self._goal is not None:
            # goal beacon: a 0.35 m-radius TALL post at the goal, visible
            # over the maze walls (x-ray in this 2.5-D column renderer —
            # physically a tower above single-story walls). Round-3
            # diagnosis: when the post was wall-occluded the task had NO
            # per-step observable direction signal outside ego-map range
            # (instruction bearing is start-relative; the map shows the
            # goal only inside the ego crop), so imitation rationally
            # collapsed to forward-wandering. The tower plays the role a
            # language landmark plays in Matterport scenes: a visual cue
            # the policy can servo on across the whole 4-8 m approach.
            gx = self._goal[0] - self._pos[0]
            gz = self._goal[2] - self._pos[2]
            t = gx * dir_x + gz * dir_z  # along-ray distance
            perp2 = (gx - t * dir_x) ** 2 + (gz - t * dir_z) ** 2
            beacon = (t > 0.0) & (perp2 < 0.35 ** 2) & (t < self.max_depth_m)
            hit_r = np.where(beacon, t, hit_r)
            labels = np.where(beacon, 26, labels)
        depths = hit_r * np.cos(alphas)  # perpendicular z-depth
        return depths, labels

    def render(self) -> Dict[str, np.ndarray]:
        dh, dw = self.depth_hw
        depths, labels = self._raycast(dw)
        depth = np.broadcast_to(
            (depths / self.max_depth_m).clip(0.0, 1.0).astype(np.float32),
            (dh, dw),
        ).copy()[..., None]

        rh, rw = self.rgb_hw
        rd, rl = self._raycast(rw)
        # deterministic procedural colors: label + distance shading
        base = ((rl[None, :] * 37 + 13) % 255).astype(np.float32)
        shade = (1.0 - (rd[None, :] / self.max_depth_m)).clip(0.1, 1.0)
        rgb = np.stack([
            (base * shade) % 255,
            ((base * 1.7 + 29) * shade) % 255,
            ((base * 2.3 + 71) * shade) % 255,
        ], axis=-1).astype(np.float32)
        rgb = np.broadcast_to(rgb, (rh, rw, 3)).copy()
        if self._goal is not None:
            bc = rl == 26
            if bc.any():
                # unshaded saturated beacon color: wall colors wrap mod 255
                # under distance shading (non-monotonic hues), so the
                # beacon gets the one hue the trunk can never confuse
                rgb[:, bc] = np.array([255.0, 40.0, 220.0], np.float32)

        sem = np.broadcast_to(labels[None, :], (dh, dw)).copy()
        return {"rgb": rgb, "depth": depth, "semantic": sem}
