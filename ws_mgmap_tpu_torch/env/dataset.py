"""Episode dataset: R2R_VLNCE json.gz loading, rank sharding, FakeSim data.

Re-provides `VLNCEDatasetV1` / `VLNExtendedEpisode`
(`habitat_extensions/task.py:19-127`): gzip-JSON episodes with instruction
vocab, per-scene rank sharding (`_split_dataset`, `task.py:61-82`), and the
scene round-robin split used by the vectorized envs
(`common/env_utils.py:46-51`). Also generates deterministic FakeSim episode
sets so the full trainer stack runs without Matterport3D data.

The port's copy of ``ws_mgmap_tpu/env/dataset.py``.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ws_mgmap_tpu_torch.env.sim import get_scene
from ws_mgmap_tpu_torch.utils.geometry import quat_from_coeffs


@dataclasses.dataclass
class Episode:
    episode_id: str
    scene_id: str
    start_position: List[float]
    start_rotation: List[float]  # [x, y, z, w] like habitat datasets
    goals: List[Dict[str, Any]]
    instruction: Dict[str, Any]
    reference_path: Optional[List[List[float]]] = None
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def start_rotation_quat(self) -> np.ndarray:
        return quat_from_coeffs(self.start_rotation)


class VLNCEDataset:
    """Loads {split}.json.gz in the R2R_VLNCE_v1-2 format."""

    def __init__(self, episodes: List[Episode],
                 vocab: Optional[List[str]] = None):
        self.episodes = episodes
        self.vocab = vocab or []

    @classmethod
    def from_file(cls, path: str) -> "VLNCEDataset":
        with gzip.open(path, "rt") as f:
            data = json.load(f)
        vocab = data.get("instruction_vocab", {}).get("word_list", [])
        episodes = []
        for ep in data["episodes"]:
            episodes.append(Episode(
                episode_id=str(ep["episode_id"]),
                scene_id=ep["scene_id"],
                start_position=ep["start_position"],
                start_rotation=ep["start_rotation"],
                goals=[g if isinstance(g, dict) else {"position": g}
                       for g in ep.get("goals", [])],
                instruction=ep["instruction"],
                reference_path=ep.get("reference_path"),
                info=ep.get("info", {}),
            ))
        return cls(episodes, vocab)

    def scenes(self) -> List[str]:
        return sorted({ep.scene_id for ep in self.episodes})

    def split_by_rank(self, split_num: int, split_rank: int) -> "VLNCEDataset":
        """Per-scene contiguous rank sharding (`task.py:61-82`)."""
        if split_num <= 1:
            return self
        by_scene: Dict[str, List[Episode]] = {}
        for ep in self.episodes:
            by_scene.setdefault(ep.scene_id, []).append(ep)
        out: List[Episode] = []
        for scene in by_scene:
            eps = by_scene[scene]
            if len(eps) < 4:
                continue
            per = int(math.floor(len(eps) / split_num))
            chunks = [eps[i:i + per] for i in range(0, len(eps), per)]
            if len(chunks) > split_num:
                chunks[-2].extend(chunks[-1])
                del chunks[-1]
            out.extend(chunks[split_rank])
        return VLNCEDataset(out, self.vocab)

    def filter_scenes(self, scenes: List[str]) -> "VLNCEDataset":
        keep = set(scenes)
        return VLNCEDataset(
            [ep for ep in self.episodes if ep.scene_id in keep], self.vocab)


def round_robin_scene_split(scenes: List[str], n: int) -> List[List[str]]:
    """`construct_envs` scene assignment (`env_utils.py:48-51`)."""
    splits: List[List[str]] = [[] for _ in range(n)]
    for idx, scene in enumerate(scenes):
        splits[idx % n].append(scene)
    return splits


# ---------------------------------------------------------------------------
def make_fake_dataset(
    num_episodes: int = 8,
    scenes: Optional[List[str]] = None,
    seed: int = 0,
    vocab_size: int = 2504,
    max_instruction_len: int = 200,
    min_geodesic: float = 4.0,
    max_geodesic: float = 8.0,
) -> VLNCEDataset:
    """Deterministic FakeSim episodes with feasible start/goal pairs.

    ``min_geodesic`` stays above the task's SUCCESS_DISTANCE (3.0,
    `vlnce_task.yaml:24`) so no episode starts pre-solved — an untrained
    agent scores ~0 and eval deltas measure actual navigation."""
    scenes = scenes or ["fake/sceneA", "fake/sceneB"]
    rng = np.random.RandomState(seed)
    episodes: List[Episode] = []
    eid = 0
    while len(episodes) < num_episodes:
        scene_id = scenes[len(episodes) % len(scenes)]
        scene = get_scene(scene_id)
        start = scene.sample_navigable(rng)
        goal = scene.sample_navigable(rng)
        d = scene.geodesic_distance(start, goal)
        if not (min_geodesic <= d <= max_geodesic):
            continue
        yaw = float(rng.uniform(-math.pi, math.pi))
        path = [p.tolist() for p in scene.shortest_path_points(start, goal)]
        # Instructions carry real goal information (like language does):
        # tokens encode the start-relative goal bearing (16 bins) and
        # distance (8 bins), mixed with filler. This makes FakeSim a genuine
        # learning testbed, not just a smoke harness. Two deliberate design
        # points (learning-check round-3 diagnosis): the signal tokens
        # repeat so the biLSTM cannot miss them, and filler comes from a
        # SMALL shared vocab — high-entropy filler made each instruction a
        # unique episode key, letting a tiny model memorize instruction ->
        # waypoint-sequence on the train split and transfer nothing
        # (rollout waypoint cosine vs oracle ~= 0 on val).
        rel = np.asarray(goal) - start
        bearing = math.atan2(-rel[0], -rel[2]) - yaw
        bearing_bin = int(((bearing + math.pi) % (2 * math.pi)) / (2 * math.pi) * 16)
        dist_bin = min(int(d / 1.5), 7)
        n_tok = int(rng.randint(12, 24))
        sig = [2 + bearing_bin, 20 + dist_bin]
        tokens = list(sig)
        for t in rng.randint(40, 48, size=n_tok - 6).tolist():
            tokens.append(t)
        tokens += sig + sig  # repeat signal at the tail as well
        tokens += [0] * (max_instruction_len - len(tokens))
        episodes.append(Episode(
            episode_id=str(eid),
            scene_id=scene_id,
            start_position=start.tolist(),
            start_rotation=[0.0, math.sin(yaw / 2), 0.0, math.cos(yaw / 2)],
            goals=[{"position": goal.tolist(), "radius": 3.0}],
            instruction={
                "instruction_text": f"fake instruction {eid}",
                "instruction_tokens": tokens,
            },
            reference_path=path,
            info={"geodesic_distance": float(d)},
        ))
        eid += 1
    return VLNCEDataset(episodes)


def fake_gt_locations(dataset: VLNCEDataset) -> Dict[str, Any]:
    """{split}_gt.json.gz equivalent for FakeSim episodes."""
    return {
        ep.episode_id: {"locations": ep.reference_path or []}
        for ep in dataset.episodes
    }
