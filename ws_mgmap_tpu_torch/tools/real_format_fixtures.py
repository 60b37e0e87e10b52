"""Miniature data files in the reference's exact schemas.

The port's copy of ``build_fixtures`` of ``tests/test_real_data_formats.py``
(a package module reads nothing from ``tests/``):
  * ``{split}.json.gz``: episodes + ``instruction_vocab`` (task.py:19-127)
  * ``embeddings.json.gz``: vocab x 50 floats (config/default.py:82-92)
  * ``{split}_gt.json.gz``: {episode: {locations, forward_steps, actions}}
    (measures.py:227-238)
  * ``map_data/{split}/ep_<id>.npy``: 480 x 480 semantic maps
    (sensors.py:368-387)
"""
import gzip
import json
import os

import numpy as np

VOCAB = ["<pad>", "<unk>", "walk", "to", "the", "kitchen", "stop", "left",
         "right", "forward"]


def build_fixtures(root: str, split: str = "val_seen", n_eps: int = 4
                   ) -> np.ndarray:
    """Write ``n_eps`` episodes of ``split`` (two FakeSim-able scenes)
    and the shared embeddings under ``root``; returns the embeddings."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    episodes = []
    gt = {}
    scenes = ["mp3d/sceneA/sceneA.glb", "mp3d/sceneB/sceneB.glb"]
    for i in range(n_eps):
        start = [float(rng.uniform(-2, 2)), 0.0, float(rng.uniform(-2, 2))]
        goal = [start[0] + 2.5, 0.0, start[2] + 1.0]
        tokens = [2, 3, 4, 5] + [0] * 196  # "walk to the kitchen"
        path = [start, [start[0] + 1.2, 0.0, start[2] + 0.5], goal]
        episodes.append({
            "episode_id": i,
            "trajectory_id": 1000 + i,
            "scene_id": scenes[i % 2],
            "start_position": start,
            "start_rotation": [0.0, 0.0, 0.0, 1.0],
            "info": {"geodesic_distance": 2.7},
            "goals": [{"position": goal, "radius": 3.0}],
            "instruction": {
                "instruction_id": str(7000 + i),
                "instruction_text": "walk to the kitchen",
                "instruction_tokens": tokens,
            },
            "reference_path": path,
        })
        gt[str(i)] = {
            "locations": path,
            "forward_steps": 11,
            "actions": [1] * 11 + [0],
        }

    with gzip.open(os.path.join(root, f"{split}.json.gz"), "wt") as f:
        json.dump({
            "episodes": episodes,
            "instruction_vocab": {
                "word_list": VOCAB,
                "word2idx_dict": {w: i for i, w in enumerate(VOCAB)},
                "itos": VOCAB, "num_vocab": len(VOCAB), "UNK_INDEX": 1,
                "PAD_INDEX": 0,
            },
        }, f)

    emb = rng.randn(len(VOCAB), 50).astype(np.float64)
    emb[0] = 0.0  # PAD row
    with gzip.open(os.path.join(root, "embeddings.json.gz"), "wt") as f:
        json.dump(emb.tolist(), f)

    with gzip.open(os.path.join(root, f"{split}_gt.json.gz"), "wt") as f:
        json.dump(gt, f)

    map_dir = os.path.join(root, "map_data", split)
    os.makedirs(map_dir, exist_ok=True)
    for i in range(n_eps):
        sem = np.full((480, 480), 7, np.int64)  # distinctive non-synth value
        sem[:10, :10] = 3
        np.save(os.path.join(map_dir, f"ep_{i}.npy"), sem)
    return emb
