"""Semantic label taxonomies + offline GT-map cache generation.

Re-provides the reference's label conversions and map builders
(`vlnce_baselines/common/utils.py:102-238`): mpcat40 -> 27-class and
-> 3-class reductions, scene point-cloud slicing around the agent height,
and rasterization of a pose-aligned top-down GT semantic map — used to
build the ``data/map_data/semantic/{split}/ep_<id>.npy`` caches consumed by
the GT semantic-map sensor (`habitat_extensions/sensors.py:362-410`).

The port's copy of ``ws_mgmap_tpu/env/semantics.py``.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

# mpcat40 (41 ids incl. void) -> 27 training classes
# (`common/utils.py:102-104`, also `sensors.py:324-328`)
LABEL_40_TO_27 = np.array([
    0, 15, 17, 1, 2, 3, 18, 19, 4, 15, 5, 6, 16, 20, 7, 8, 17, 17,
    9, 21, 22, 16, 10, 11, 15, 12, 13, 23, 16, 16, 16, 16, 16,
    24, 25, 16, 16, 14, 26, 16, 16,
], np.int32)

# mpcat40 -> 3 spatial classes {void, floor-ish, wall-ish}
# (`common/utils.py:105-107`)
LABEL_40_TO_3 = np.array([
    0, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1,
], np.int32)


def convert_labels(label_seq: np.ndarray, to: int = 27) -> np.ndarray:
    """Map raw mpcat40 ids (with -1/void) to the reduced label set."""
    table = LABEL_40_TO_27 if to == 27 else LABEL_40_TO_3
    lab = np.clip(np.asarray(label_seq, np.int64), -1, 40)
    lab = np.where(lab < 0, 0, lab)
    return table[lab]


def load_scene_pcloud(preprocessed_dir: str, scene_id: str,
                      num_classes: int = 27):
    """Load `<scene>_pcloud.npz` (x, y, z, label_seq)
    (`common/utils.py:124-144`). Returns ((x, y, z), labels27, labels3)."""
    path = os.path.join(preprocessed_dir, f"{scene_id}_pcloud.npz")
    data = np.load(path)
    x, y, z = data["x"], data["y"], data["z"]
    labels = np.asarray(data["label_seq"]).reshape(-1)
    return (x, y, z), convert_labels(labels, 3), convert_labels(labels, 27)


def slice_scene(x, y, z, labels, height: float,
                below: float = 0.2, above: float = 2.0):
    """Keep points within the agent's vertical band
    (`common/utils.py:176-196`)."""
    keep = (z >= height - below) & (z <= height + above)
    return x[keep], y[keep], labels[keep]


def rasterize_gt_map(
    x: np.ndarray,
    y: np.ndarray,
    labels: np.ndarray,
    abs_pose: Tuple[float, float, float],
    grid_dim: int = 480,
    cell_size: float = 0.12,
    z_order: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Pose-aligned top-down label grid (`get_gt_map`,
    `common/utils.py:198-238`): rotate/translate the point map into the
    agent frame, bin at ``cell_size``, later points (higher z) win."""
    angle = -abs_pose[2]
    rot = np.array([[np.cos(angle), -np.sin(angle)],
                    [np.sin(angle), np.cos(angle)]])
    pts = np.stack([x, y]) - np.array([[-abs_pose[1]], [abs_pose[0]]])
    pts = rot @ pts

    cols = np.floor(pts[0] / cell_size) + (grid_dim - 1) / 2.0
    rows = np.floor(pts[1] / cell_size) + (grid_dim - 1) / 2.0
    cols = np.clip(cols, 0, grid_dim - 1).astype(np.int64)
    rows = np.clip(rows, 0, grid_dim - 1).astype(np.int64)

    if z_order is not None:
        order = np.argsort(z_order)
        rows, cols, labels = rows[order], cols[order], labels[order]

    grid = np.zeros((grid_dim, grid_dim), np.float32)
    grid[rows, cols] = labels
    return grid[::-1].copy()  # flip to align with observations


def build_episode_gt_map(sim, episode, out_dir: str,
                         grid_dim: int = 480, cell_size: float = 0.12) -> str:
    """Build + save ``ep_<id>.npy`` for one episode (FakeSim or point-cloud
    backend); the on-the-fly path in env/sensors.py uses the same layout."""
    os.makedirs(out_dir, exist_ok=True)
    scene = getattr(sim, "scene", None)
    start = np.asarray(episode.start_position)
    if scene is not None:
        half = scene.spec.extent_m / 2.0
        zs = start[2] + (np.arange(grid_dim) - grid_dim // 2) * cell_size
        xs = start[0] + (np.arange(grid_dim) - grid_dim // 2) * cell_size
        rows = np.clip(((zs + half) / scene.spec.cell_m).astype(np.int64),
                       0, scene.n - 1)
        cols = np.clip(((xs + half) / scene.spec.cell_m).astype(np.int64),
                       0, scene.n - 1)
        grid = scene.sem[rows[:, None], cols[None, :]].astype(np.float32)
    else:
        grid = np.zeros((grid_dim, grid_dim), np.float32)
    path = os.path.join(out_dir, f"ep_{episode.episode_id}.npy")
    np.save(path, grid)
    return path
