"""The port's grid-pose helpers, space descriptors and GT-map cache
builder against the JAX package's, exactly: ``utils/grid_pose.py`` on
seeded poses (headings at and around +-pi, points past the grid's edges,
``get_coord_pose``'s float64 ``round`` at .5 ties), ``env/spaces.py``
field by field, and ``build_gt_maps`` writing byte-identical
``ep_<id>.npy`` files to ``tools/build_gt_maps.py`` from a 3-episode
FakeSim split and from a scene point cloud."""
import dataclasses
import gzip
import json
import math
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from ws_mgmap_tpu.env import spaces as jspaces
from ws_mgmap_tpu.utils import grid_pose as jgrid_pose
from ws_mgmap_tpu.utils.geometry import AgentState as JAgentState
from ws_mgmap_tpu_torch.env import spaces
from ws_mgmap_tpu_torch.env.dataset import make_fake_dataset
from ws_mgmap_tpu_torch.tools import build_gt_maps
from ws_mgmap_tpu_torch.utils import grid_pose
from ws_mgmap_tpu_torch.utils.geometry import AgentState, quat_from_yaw

ROOT = Path(__file__).resolve().parents[1]
HEADINGS = [math.pi, -math.pi, math.pi - 1e-12, -math.pi + 1e-12,
            math.nextafter(math.pi, 0.0), 0.0, math.pi / 2, -math.pi / 2]


def _poses(rng, n):
    """(x, y, heading) poses: seeded ones, the headings above, and
    positions far past a 512-cell grid at 5 cm (12.8 m each way)."""
    out = [(float(x), float(y), float(o)) for x, y, o in zip(
        rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
        rng.uniform(-math.pi, math.pi, n))]
    out += [(float(rng.uniform(-3, 3)), float(rng.uniform(-3, 3)), o)
            for o in HEADINGS]
    out += [(sx * 40.0, sy * 40.0, o) for sx in (-1, 1) for sy in (-1, 1)
            for o in (math.pi, -math.pi)]
    return out


def test_spaces_equal_jax():
    for name in ("Box", "Discrete"):
        assert ([f.name for f in dataclasses.fields(getattr(spaces, name))]
                == [f.name for f in dataclasses.fields(getattr(jspaces,
                                                               name))])
    w, jw = spaces.WAYPOINT_ACTION_SPACE, jspaces.WAYPOINT_ACTION_SPACE
    assert dataclasses.astuple(w) == dataclasses.astuple(jw)
    assert dataclasses.is_dataclass(w) and w.__dataclass_params__.frozen
    with pytest.raises(dataclasses.FrozenInstanceError):
        w.low = 1.0
    assert spaces.Discrete(4) == spaces.Discrete(4) != spaces.Discrete(3)
    d = spaces.DictSpace(rgb=spaces.Box(0, 255, (224, 224, 3)))
    assert d.spaces is d and d.spaces["rgb"].shape == (224, 224, 3)


def test_rel_pose_and_coord_pose_equal_jax():
    rng = np.random.RandomState(0)
    poses = _poses(rng, 200)
    for p2, p1 in zip(poses, poses[1:] + poses[:1]):
        rel = grid_pose.get_rel_pose(p2, p1)
        assert rel == jgrid_pose.get_rel_pose(p2, p1)
        assert (grid_pose.get_rel_pose(p2[:2], p1)
                == jgrid_pose.get_rel_pose(p2[:2], p1))
        for dim, cell in ((512, 0.05), (480, 0.12), (7, 1.0)):
            got = grid_pose.get_coord_pose(rel, p1, dim, cell)
            want = jgrid_pose.get_coord_pose(rel, p1, dim, cell)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    # exact .5 ties: Python's round goes to the even neighbour
    for r in (0.5, 1.5, -0.5, -2.5, 3.5):
        rel = (0.0, -r, 0.0)
        got = grid_pose.get_coord_pose(rel, (0.0, 0.0, 0.0), 8, 1.0)
        assert np.array_equal(
            got, jgrid_pose.get_coord_pose(rel, (0.0, 0.0, 0.0), 8, 1.0))
        assert got[0, 0] == min(max(round(r + 3), 0), 7)


def test_discretize_unravel_transform_equal_jax():
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.uniform(-30, 30, 300), [-1e3, 1e3, 0.0]])
    z = np.concatenate([rng.uniform(-30, 30, 300), [1e3, -1e3, 0.0]])
    for dim, cell, tr in (((512, 512), 0.05, 0.0), ((480, 480), 0.12, 3.0)):
        got = grid_pose.discretize_coords(x, z, dim, cell, tr)
        want = jgrid_pose.discretize_coords(x, z, dim, cell, tr)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    idx = rng.randint(-10**6, 10**6, 500)
    for shape in ((512, 512), (4, 5, 6)):
        assert np.array_equal(grid_pose.unravel_index(idx, shape),
                              jgrid_pose.unravel_index(idx, shape))
    poses = _poses(rng, 20)
    for t in range(len(poses)):
        ego = rng.uniform(-50, 50, 2)
        pc, apc = rng.uniform(0, 512, 2), rng.uniform(0, 512, 2)
        got = grid_pose.transform_ego_to_geo(ego, pc, apc, poses, t)
        want = jgrid_pose.transform_ego_to_geo(ego, pc, apc, poses, t)
        assert np.array_equal(got, want)


def test_pose_trace_equal_jax():
    rng = np.random.RandomState(2)
    trace = grid_pose.PoseTrace()
    jtrace = jgrid_pose.PoseTrace()
    for t, (x, z, o) in enumerate(_poses(rng, 30)):
        pos = np.array([x, float(rng.uniform(-1, 1)), z])
        q = quat_from_yaw(o)
        assert (trace.append(AgentState(pos, q))
                == jtrace.append(JAgentState(pos.copy(), q.copy())))
        assert np.array_equal(trace.agent_grid_coords(t),
                              jtrace.agent_grid_coords(t))
        wp = rng.uniform(-20, 20, 3)
        assert np.array_equal(trace.waypoint_grid_coords(wp, t),
                              jtrace.waypoint_grid_coords(wp, t))
    assert trace.heights == jtrace.heights
    trace.reset()
    assert trace.abs_poses == [] and trace.heights == []


def _write_split(path: Path, n: int) -> list[str]:
    ds = make_fake_dataset(num_episodes=n, seed=3,
                           scenes=["fake/gt_a", "fake/gt_b"])
    eps = [dict(dataclasses.asdict(e), episode_id=int(e.episode_id))
           for e in ds.episodes]
    with gzip.open(path, "wt") as f:
        json.dump({"episodes": eps}, f)
    return [e.episode_id for e in ds.episodes]


def _run_jax_tool(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["build_gt_maps.py"] + argv)
    runpy.run_path(str(ROOT / "tools" / "build_gt_maps.py"),
                   run_name="__main__")


def _same_files(a: Path, b: Path, n: int) -> None:
    names = sorted(p.name for p in a.iterdir())
    assert len(names) == n and names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
        assert np.load(a / name).shape == (480, 480)


def test_build_gt_maps_fakesim_equals_jax(tmp_path, monkeypatch):
    split = tmp_path / "val.json.gz"
    ids = _write_split(split, 3)
    _run_jax_tool(["--out", str(tmp_path / "jax"), "--episodes", str(split)],
                  monkeypatch)
    assert build_gt_maps.main(["--out", str(tmp_path / "port"),
                               "--episodes", str(split)]) == 0
    _same_files(tmp_path / "port", tmp_path / "jax", 3)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        f"ep_{i}.npy" for i in ids)
    assert (np.load(tmp_path / "port" / f"ep_{ids[0]}.npy") > 0).any()


def test_build_gt_maps_pcloud_equals_jax(tmp_path, monkeypatch):
    split = tmp_path / "val.json.gz"
    _write_split(split, 3)
    rng = np.random.RandomState(4)
    clouds = tmp_path / "pclouds"
    clouds.mkdir()
    for scene in ("gt_a", "gt_b"):
        n = 5000
        np.savez(clouds / f"{scene}_pcloud.npz",
                 x=rng.uniform(-20, 20, n), y=rng.uniform(-20, 20, n),
                 z=rng.uniform(-1, 3, n), label_seq=rng.randint(-1, 41, n))
    args = ["--episodes", str(split), "--pcloud-dir", str(clouds)]
    _run_jax_tool(["--out", str(tmp_path / "jax")] + args, monkeypatch)
    build_gt_maps.main(["--out", str(tmp_path / "port")] + args)
    _same_files(tmp_path / "port", tmp_path / "jax", 3)
