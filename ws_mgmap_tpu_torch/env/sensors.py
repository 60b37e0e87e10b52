"""Task-layer sensors computed on the host against a SimBackend.

Re-provides the reference's habitat sensor suite
(`habitat_extensions/sensors.py`): oracle action, progress, waypoint
supervision (fog-of-war frontier), GT-path distance map, GT semantic map
crop, heading, plus habitat's built-in GPS/compass/instruction sensors the
task config enables (`vlnce_task.yaml:25-35`). Each sensor is a callable
``(sim, episode, ctx) -> np.ndarray`` registered under its uuid.

The port's copy of ``ws_mgmap_tpu/env/sensors.py``, without OpenCV: the
path sensor rasterises with ``draw_line`` (OpenCV's ``cv2.line``,
``LINE_8``, at any thickness, exactly) and takes SciPy's exact Euclidean
distance transform where the JAX package calls ``cv2.distanceTransform``.
"""
from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
from scipy import ndimage

from ws_mgmap_tpu_torch.env.warp_np import (
    affine_grid_np,
    grid_sample_nearest_np,
    rotation_theta_np,
    translation_theta_np,
)
from ws_mgmap_tpu_torch.utils.geometry import (
    AgentState,
    TransformationRealworldAgent,
    heading_from_quaternion,
    quat_inverse,
    quat_mul,
    quat_rotate_vector,
    yaw_from_quaternion,
)

# habitat maps.COORDINATE_MIN/MAX used by the waypoint/path sensors
# (`sensors.py:106-107`, `action_maker.py:13-15`).
COORDINATE_MIN = -62.3241 - 1e-6
COORDINATE_MAX = 90.0399 + 1e-6

SENSOR_REGISTRY: Dict[str, Callable] = {}


def register_sensor(uuid: str):
    def deco(fn):
        SENSOR_REGISTRY[uuid] = fn
        return fn
    return deco


class SensorContext:
    """Per-episode state shared by sensors (start pose, caches, config)."""

    def __init__(self, config):
        self.config = config
        self.episode_id: Optional[str] = None
        self.start_state: Optional[AgentState] = None
        self.record_heading: float = 0.0
        self.gt_locations: Dict[str, Any] = {}
        self._gt_semmap: Optional[np.ndarray] = None
        self._gt_semmap_rotated: Optional[np.ndarray] = None

    def on_episode_start(self, sim, episode):
        self.episode_id = str(episode.episode_id)
        self.start_state = sim.get_agent_state()
        self._gt_semmap = None
        self._gt_semmap_rotated = None


# ---------------------------------------------------------------------------
@register_sensor("gps")
def gps_sensor(sim, episode, ctx: SensorContext) -> np.ndarray:
    """habitat GPSSensor, DIMENSIONALITY=2: start-frame (-dz, dx)."""
    st = ctx.start_state
    ag = sim.get_agent_state()
    rel = quat_rotate_vector(quat_inverse(st.rotation), ag.position - st.position)
    return np.array([-rel[2], rel[0]], np.float32)


@register_sensor("compass")
def compass_sensor(sim, episode, ctx) -> np.ndarray:
    """habitat CompassSensor: heading relative to episode start."""
    st = ctx.start_state
    ag = sim.get_agent_state()
    rel = quat_mul(quat_inverse(st.rotation), ag.rotation)
    direction = quat_rotate_vector(rel, np.array([0.0, 0.0, -1.0]))
    phi = math.atan2(direction[0], -direction[2])
    return np.array([phi], np.float32)


@register_sensor("heading")
def heading_sensor(sim, episode, ctx) -> np.ndarray:
    """`HeadingSensor` (`sensors.py:412-451`), incl. the record_heading
    side-channel consumed by the GT semantic-map sensor."""
    ag = sim.get_agent_state()
    h = heading_from_quaternion(quat_inverse(ag.rotation))
    ctx.record_heading = float(h)
    sim.record_heading = float(h)
    return np.array([h], np.float32)


@register_sensor("progress")
def progress_sensor(sim, episode, ctx) -> np.ndarray:
    """`VLNOracleProgressSensor` (`sensors.py:64-94`)."""
    cur = sim.get_agent_state().position
    d_now = sim.geodesic_distance(cur, episode.goals[0]["position"])
    d_start = episode.info["geodesic_distance"]
    if not math.isfinite(d_now) or d_start <= 0:
        return np.array([0.0], np.float32)
    return np.array([(d_start - d_now) / d_start], np.float32)


@register_sensor("instruction")
def instruction_sensor(sim, episode, ctx) -> Dict[str, Any]:
    return {
        "text": episode.instruction.get("instruction_text", ""),
        "tokens": np.asarray(episode.instruction["instruction_tokens"], np.int64),
    }


def clip_line(w: int, h: int, p1, p2):
    """OpenCV's ``clipLine`` on a w x h image (``drawing.cpp``): the
    segment's ends moved onto the image's border along the line, each
    offset truncated toward zero from a double, the second end from the
    first end's clipped position, as OpenCV does; ``None`` when the
    segment misses the image."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def line_pixels(p1, p2, w: int, h: int) -> List[tuple]:
    """The (x, y) pixels ``cv2.line(img, p1, p2, color, 1, cv2.LINE_8)``
    sets on a w x h image, for integer ends anywhere: OpenCV's
    ``LineIterator`` (8-connected, left to right) over the segment as
    ``clipLine`` leaves it."""
    p1 = (int(p1[0]), int(p1[1]))
    p2 = (int(p2[0]), int(p2[1]))
    if not (0 <= p1[0] < w and 0 <= p2[0] < w
            and 0 <= p1[1] < h and 0 <= p2[1] < h):
        clipped = clip_line(w, h, p1, p2)
        if clipped is None:
            return []
        p1, p2 = clipped
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:  # left to right
        p1, p2, dx, dy = p2, p1, -dx, -dy
    step_x, step_y = 1, 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # along the major axis every pixel; along the minor one where the
    # error term, tested before its update, is negative
    err = dx - 2 * dy
    x, y = p1
    out = []
    for _ in range(dx + 1):
        out.append((x, y))
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += step_y
            x += step_x if minor else 0
        else:
            x += step_x
            y += step_y if minor else 0
    return out


XY_SHIFT = 16  # OpenCV's fixed point for thick lines (drawing.cpp)
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _put(img: np.ndarray, x: int, y: int) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = 255


def _line_fixed(img: np.ndarray, p1, p2) -> None:
    """OpenCV's ``Line2``: a 1-pixel line between fixed-point ends
    (``XY_SHIFT`` fractional bits), clipped to the image scaled to fixed
    point, stepping the major axis pixel by pixel."""
    h, w = img.shape
    clipped = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    x1, y1 = x1 + half, y1 + half
    _put(img, (x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            _put(img, x1, y1 >> XY_SHIFT)
            x1, y1 = x1 + 1, y1 + y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            _put(img, x1 >> XY_SHIFT, y1)
            x1, y1 = x1 + x_step, y1 + 1


def _fill_convex_fixed(img: np.ndarray, v) -> None:
    """OpenCV's ``FillConvexPoly`` for ``LINE_8`` over fixed-point
    vertices: the outline by :func:`_line_fixed`, then one span a row
    between the left and right edges, each edge stepped by a rounded
    fixed-point slope."""
    h, w = img.shape
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line_fixed(img, p0, p)
        p0 = p
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin = (min(p[0] for p in v) + delta) >> XY_SHIFT
    xmax = (max(p[0] for p in v) + delta) >> XY_SHIFT
    ymin = (min(ys) + delta) >> XY_SHIFT
    ymax = (max(ys) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [vertex index, direction, x, dx, last row]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % npts
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + delta) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e[4] = ty
                    e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    e[2] = xs
                    e[0] = idx
                    break
                idx0, idx = idx, (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = ((1, 0) if edge[0][2] > edge[1][2] else (0, 1))
            xx1 = (edge[left][2] + delta) >> XY_SHIFT
            xx2 = (edge[right][2] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = 255
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _fill_circle(img: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """OpenCV's filled ``Circle``: the midpoint walk's spans, clipped."""
    h, w = img.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                         (cy + dx, dy)):
            if 0 <= yy < h and cx - half < w and cx + half >= 0:
                img[yy, max(cx - half, 0):min(cx + half, w - 1) + 1] = 255
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def draw_line(img: np.ndarray, p1, p2, thickness: int = 1) -> None:
    """``cv2.line(img, p1, p2, 255, thickness)`` (``LINE_8``, no shift)
    on a uint8 image, pixel for pixel: width 1 by :func:`line_pixels`; a
    thicker line as OpenCV 5's ``ThickLine`` draws it. The segment is
    first clipped to the image grown by ``thickness`` pixels a side; then
    a convex polygon around it in 16-bit fixed point, its half-width
    ``thickness / 2`` (+ 0.5 when odd), and a filled round cap of radius
    ``(thickness + 1) // 2`` at each end."""
    p1 = (int(p1[0]), int(p1[1]))
    p2 = (int(p2[0]), int(p2[1]))
    h, w = img.shape
    if thickness <= 1:
        for x, y in line_pixels(p1, p2, w, h):
            img[y, x] = 255
        return
    m = thickness
    clipped = clip_line(w + 2 * m, h + 2 * m, (p1[0] + m, p1[1] + m),
                        (p2[0] + m, p2[1] + m))
    if clipped is None:
        return
    (x0, y0), (x1, y1) = [((x - m) << XY_SHIFT, (y - m) << XY_SHIFT)
                          for x, y in clipped]
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        # cvRound: to nearest, ties to even (as Python's round)
        ddx, ddy = round(dy * r), round(dx * r)
        _fill_convex_fixed(img, [(x0 + ddx, y0 + ddy), (x0 - ddx, y0 - ddy),
                                 (x1 - ddx, y1 - ddy), (x1 + ddx, y1 + ddy)])
    radius = (t + (XY_ONE >> 1)) >> XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        _fill_circle(img, x >> XY_SHIFT, y >> XY_SHIFT, radius)


# ---------------------------------------------------------------------------
@register_sensor("vln_oracle_action_sensor")
def oracle_action_sensor(sim, episode, ctx) -> np.ndarray:
    """`VLNOracleActionSensor` (`sensors.py:26-61`): next greedy action
    along the shortest path to the goal."""
    action = greedy_follower_action(sim, episode.goals[0]["position"],
                                    goal_radius=0.5)
    # None -> STOP, as in the reference sensor (`sensors.py:58-61`)
    return np.array([0 if action is None else action], np.float32)


class ShortestPathFollower:
    """Class surface of the reference's `ShortestPathFollowerCompat`
    (`habitat_extensions/shortest_path_follower.py:25-187`): greedy geodesic
    follower with a mode attribute and `get_next_action`."""

    def __init__(self, sim, goal_radius: float = 0.5,
                 return_one_hot: bool = False):
        assert not return_one_hot
        self._sim = sim
        self._goal_radius = goal_radius
        self.mode = "geodesic_path"

    def get_next_action(self, goal_pos) -> Optional[int]:
        return greedy_follower_action(self._sim, goal_pos, self._goal_radius)


def greedy_follower_action(sim, goal, goal_radius: float = 0.5):
    """Geodesic greedy follower (ShortestPathFollowerCompat-equivalent,
    `habitat_extensions/shortest_path_follower.py:25-187`): steer toward
    the next shortest-path vertex, FORWARD when roughly aligned.

    Returns **None** when already within ``goal_radius`` — exactly the
    reference follower (`shortest_path_follower.py:62-69`). The two callers
    interpret None differently, and the distinction is load-bearing:
    the oracle-action sensor maps None -> STOP (`sensors.py:58-61`), while
    GTMapActionMaker maps None -> MOVE_FORWARD (`action_maker.py:41-44`) —
    reaching the *waypoint* must NOT end the episode (conflating these
    made any near-agent waypoint prediction an instant episode stop,
    poisoning beta<1 DAgger collection; round-3 diagnosis)."""
    ag = sim.get_agent_state()
    if sim.geodesic_distance(ag.position, goal) < goal_radius:
        return None
    pts = sim.get_straight_shortest_path_points(ag.position, goal)
    if len(pts) < 2:
        # no usable gradient direction: the reference moves forward
        # (`shortest_path_follower.py:71-73`)
        return 1
    # first vertex sufficiently far from the agent
    target = pts[-1]
    for p in pts[1:]:
        if np.linalg.norm(np.asarray(p)[[0, 2]] - ag.position[[0, 2]]) > 0.15:
            target = p
            break
    yaw = yaw_from_quaternion(ag.rotation)
    to = np.asarray(target) - ag.position
    desired = math.atan2(-to[0], -to[2])  # forward = -z
    delta = (desired - yaw + math.pi) % (2 * math.pi) - math.pi
    half_turn = math.radians(15.0) / 2.0
    if abs(delta) <= half_turn + 1e-6:
        return 1  # MOVE_FORWARD
    # habitat: TURN_LEFT increases yaw
    return 2 if delta > 0 else 3


# ---------------------------------------------------------------------------
class WaypointSensor:
    """`VLNOracleWaypointSensor` (`sensors.py:97-254`): the supervision
    target — the point where the GT path exits a ~2.4 m circle around the
    agent, in normalized egocentric map coordinates.

    The reference rasterizes path + circle on a 1250^2 grid and DFS-walks
    pixels (`:203-254`); here the same geometry is computed on the polyline
    directly (first crossing of radius 20 * resolution along the path),
    which is the continuous limit of that pixel walk.
    """

    def __init__(self, config):
        self.map_size = config.MAP_SIZE
        self.map_resolution = config.MAP_RESOLUTION
        self.resolution = (COORDINATE_MAX - COORDINATE_MIN) / self.map_resolution
        self.radius = 20.0 * self.resolution
        law = config.LAW
        self.use_law = law.USE
        self.num_inter_waypoints = law.NUM_WAYPOINTS
        self.is_sparse = law.IS_SPARSE
        self.gt_locations: Dict[str, Any] = {}

    def set_gt_locations(self, gt_json: Dict[str, Any]):
        self.gt_locations = gt_json

    def _law_goal(self, sim, episode):
        """LAW sub-goal selection (`sensors.py:160-201`)."""
        goal = np.asarray(episode.goals[0]["position"])
        locs = None
        if self.num_inter_waypoints > 0 and str(episode.episode_id) in self.gt_locations:
            locs = [np.asarray(p) for p in
                    self.gt_locations[str(episode.episode_id)]["locations"]]
        if locs is None:
            if self.is_sparse and episode.reference_path:
                locs = [np.asarray(p) for p in episode.reference_path]
            else:
                return goal

        if self.num_inter_waypoints > 0:
            ep_len = sim.geodesic_distance(locs[0], goal)
            way_locations = [locs[0]]
            count = 0
            dist = ep_len / (self.num_inter_waypoints + 1)
            for way in locs[:-1]:
                d = sim.geodesic_distance(locs[0], way)
                if d >= dist:
                    way_locations.append(way)
                    if count >= (self.num_inter_waypoints - 1):
                        break
                    count += 1
                    dist += ep_len / (self.num_inter_waypoints + 1)
            way_locations.append(goal)
        else:
            way_locations = locs

        cur = sim.get_agent_state().position
        nearest_dist = float("inf")
        nearest_way = way_locations[-1]
        d_agent_goal = sim.geodesic_distance(cur, goal)
        for way in reversed(way_locations):
            d = sim.geodesic_distance(cur, way)
            if 3.0 <= d < nearest_dist:
                if d_agent_goal > sim.geodesic_distance(way, goal):
                    nearest_dist = d
                    nearest_way = way
        return np.asarray(nearest_way)

    def __call__(self, sim, episode, ctx) -> np.ndarray:
        ag = sim.get_agent_state()
        goal = self._law_goal(sim, episode) if self.use_law \
            else np.asarray(episode.goals[0]["position"])
        pts = sim.get_straight_shortest_path_points(ag.position, goal)
        if len(pts) < 2:
            pts = [ag.position, goal]

        waypoint = self._circle_crossing(ag.position, pts)
        tr = TransformationRealworldAgent(ag)
        wp_a = tr.realworld2agent(waypoint)
        half = self.map_size // 2
        wp_norm_x = (wp_a[0] / self.resolution) / half
        wp_norm_y = (-wp_a[2] / self.resolution) / half
        return np.array([wp_norm_x, wp_norm_y], np.float32)

    def _circle_crossing(self, center, pts: List[np.ndarray]) -> np.ndarray:
        c = np.asarray(center)[[0, 2]]
        r = self.radius
        for i in range(len(pts) - 1):
            a = np.asarray(pts[i])[[0, 2]]
            b = np.asarray(pts[i + 1])[[0, 2]]
            da, db = np.linalg.norm(a - c), np.linalg.norm(b - c)
            if da <= r <= db or db <= r <= da or (da < r and i == len(pts) - 2):
                # param t where |a + t(b-a) - c| = r
                d = b - a
                f = a - c
                aa = float(d @ d)
                if aa < 1e-12:
                    continue
                bb = 2.0 * float(f @ d)
                cc = float(f @ f) - r * r
                disc = bb * bb - 4 * aa * cc
                if disc < 0:
                    continue
                for t in sorted([(-bb - math.sqrt(disc)) / (2 * aa),
                                 (-bb + math.sqrt(disc)) / (2 * aa)]):
                    if 0.0 <= t <= 1.0:
                        hit = a + t * d
                        return np.array([hit[0], pts[0][1], hit[1]])
        return np.asarray(pts[-1])  # path never leaves the circle -> endpoint


class PathSensor:
    """`VLNOraclePathSensor` (`sensors.py:257-315`): 100x100 egocentric
    distance-transform of the rasterized GT shortest path."""

    def __init__(self, config):
        self.map_size = config.MAP_SIZE
        self.map_resolution = config.MAP_RESOLUTION
        self.line_width = config.LINE_WIDTH
        self.resolution = (COORDINATE_MAX - COORDINATE_MIN) / self.map_resolution

    def __call__(self, sim, episode, ctx) -> np.ndarray:
        ag = sim.get_agent_state()
        goal = np.asarray(episode.goals[0]["position"])
        pts = sim.get_straight_shortest_path_points(ag.position, goal)
        if len(pts) < 2:
            pts = [ag.position, goal]
        m = self.map_size
        line = np.zeros((m, m), np.uint8)
        tr = TransformationRealworldAgent(ag)
        px = []
        for p in pts:
            a = tr.realworld2agent(p)
            x = int(a[2] / self.resolution + m // 2)
            y = int(a[0] / self.resolution + m // 2)
            px.append((y, x))
        for i in range(len(px) - 1):
            draw_line(line, px[i], px[i + 1], self.line_width)
        if not line.any():
            return np.zeros((m, m), np.float32)
        # exact euclidean distance (pixels) to the rasterized path
        dist = ndimage.distance_transform_edt(line == 0)
        return dist.astype(np.float32)


class GtSemanticMapSensor:
    """`GtSemanticMapSensor` (`sensors.py:362-410`): egocentric 100x100 crop
    of the episode's 480x480 top-down GT semantic map (0.12 m cells),
    rotated by the recorded heading and translated by the agent offset.

    Two map sources: the reference's cached ``ep_<id>.npy`` files when
    ``data_dir`` exists, else on-the-fly synthesis from the sim backend
    (FakeSim scenes expose their semantic grid).
    """

    GLOBAL = 480
    CELL = 0.12

    def __init__(self, config):
        self.half_size = config.MAP_SIZE // 2
        self.data_dir = getattr(config, "DATA_DIR", "data/map_data/semantic/{split}").format(
            split=config.SPLIT)

    def _load_global(self, sim, episode, ctx) -> np.ndarray:
        path = os.path.join(self.data_dir, f"ep_{episode.episode_id}.npy")
        if os.path.exists(path):
            return np.load(path).astype(np.float32)
        scene = getattr(sim, "scene", None)
        if scene is None:
            return np.zeros((self.GLOBAL, self.GLOBAL), np.float32)
        # synthesize: resample the scene semantic grid around the episode
        # start at 0.12 m cells (row ~ +z, col ~ +x like the cached maps)
        g = self.GLOBAL
        start = ctx.start_state.position
        zs = start[2] + (np.arange(g) - g // 2) * self.CELL
        xs = start[0] + (np.arange(g) - g // 2) * self.CELL
        half = scene.spec.extent_m / 2.0
        rows = np.clip(((zs + half) / scene.spec.cell_m).astype(np.int64),
                       0, scene.n - 1)
        cols = np.clip(((xs + half) / scene.spec.cell_m).astype(np.int64),
                       0, scene.n - 1)
        gm = scene.sem[rows[:, None], cols[None, :]].astype(np.float32)
        goal_beacon = getattr(sim, "_goal", None)
        if goal_beacon is not None:
            # FakeSim goal tower (sim.py::set_goal): stamp its 0.35 m disk
            # into the synthesized GT map so the map-prediction aux loss
            # supervises the beacon's map location instead of erasing it
            r = (goal_beacon[2] - start[2]) / self.CELL + g // 2
            c = (goal_beacon[0] - start[0]) / self.CELL + g // 2
            rr, cc = np.ogrid[:g, :g]
            disk = (rr - r) ** 2 + (cc - c) ** 2 <= (0.35 / self.CELL) ** 2
            gm[disk] = 26.0
        return gm

    def __call__(self, sim, episode, ctx) -> np.ndarray:
        if ctx._gt_semmap_rotated is None:
            gm = self._load_global(sim, episode, ctx)
            theta = rotation_theta_np(float(ctx.record_heading))
            grid = affine_grid_np(theta, gm.shape[0], gm.shape[1])
            ctx._gt_semmap_rotated = grid_sample_nearest_np(gm, grid)
        gm = ctx._gt_semmap_rotated
        g = gm.shape[0]

        ag = sim.get_agent_state()
        st = ctx.start_state
        grid_y = (ag.position[0] - st.position[0]) / self.CELL + g / 2.0
        grid_x = (ag.position[2] - st.position[2]) / self.CELL + g / 2.0
        tx = (grid_y - g // 2) / (g // 2)
        ty = (grid_x - g // 2) / (g // 2)

        tra = grid_sample_nearest_np(
            gm, affine_grid_np(translation_theta_np(tx, ty), g, g))
        rot = grid_sample_nearest_np(
            tra, affine_grid_np(
                rotation_theta_np(-float(ctx.record_heading)), g, g))
        hs = self.half_size
        padded = np.pad(rot, ((hs, hs), (hs, hs)))
        # the reference crops around 289 on the padded 580 grid
        # (`sensors.py:410`); keep the exact offset.
        center = 289
        return padded[center - hs:center + hs,
                      center - hs:center + hs].astype(np.int64)


class SemanticFilterSensor:
    """`SemanticFilterSensor` (`sensors.py:318-359`): 27-class one-hot of
    the simulator semantic frame (eval-video only).

    Real simulator frames hold INSTANCE ids; the reference remaps
    instance -> mpcat40 category via the scene's semantic annotations
    (`sensors.py:349-350`, rebuilt once per episode) and then
    mpcat40 -> 27 (`sensors.py:324-328` == semantics.LABEL_40_TO_27).
    Backends without annotations (FakeSim) render 27-class labels
    directly, so only the one-hot applies."""

    def __init__(self, config):
        self.category = config.CATEGORY
        self._prev_episode_id = None
        self._mapping: Optional[np.ndarray] = None

    def _instance_mapping(self, sim, episode) -> Optional[np.ndarray]:
        ann = getattr(sim, "semantic_annotations", None)
        if ann is None:
            return None
        if self._prev_episode_id != str(episode.episode_id):
            scene = ann()
            # FakeSim's annotation object is its scene, which has no
            # instance tree (frames are category labels already)
            if scene is None or not getattr(scene, "objects", None):
                return None
            # instance id ("<region>_<idx>" -> idx) -> mpcat40 index
            # (`sensors.py:349-350`)
            inst2lab = {int(obj.id.split("_")[-1]): obj.category.index()
                        for obj in scene.objects}
            self._mapping = np.array(
                [inst2lab.get(i, -1) for i in range(max(inst2lab) + 1)],
                np.int64)
            self._prev_episode_id = str(episode.episode_id)
        return self._mapping

    def __call__(self, sim, episode, ctx,
                 semantic: Optional[np.ndarray] = None) -> np.ndarray:
        if semantic is None:
            semantic = sim.render()["semantic"]
        sem = np.asarray(semantic, np.int64)
        mapping = self._instance_mapping(sim, episode)
        if mapping is not None:
            sem = np.take(mapping, np.clip(sem, 0, len(mapping) - 1))
            # void (-1) -> 0, then mpcat40 -> 27 (`sensors.py:353-355`)
            from ws_mgmap_tpu_torch.env.semantics import convert_labels
            sem = convert_labels(sem, to=self.category)
        else:
            sem = np.clip(sem, 0, self.category - 1)
        h, w = sem.shape
        return np.eye(self.category, dtype=np.float32)[sem.reshape(-1)].reshape(
            h, w, self.category)
