"""Trainer orchestration (port of ``ws_mgmap_tpu/train/trainer.py``).

So far ``load_split``, which checkpoint evaluation needs; the trainer
loop, collection and the CLI come in a later slice.
"""
from __future__ import annotations

import gzip
import json
import os
import zlib

from ws_mgmap_tpu_torch.env.dataset import (
    VLNCEDataset,
    fake_gt_locations,
    make_fake_dataset,
)


def load_split(config, split: str):
    """Dataset + GT locations for a split; FakeSim data when the R2R_VLNCE
    files are absent."""
    path = config.TASK_CONFIG.DATASET.DATA_PATH.format(split=split)
    if os.path.exists(path):
        ds = VLNCEDataset.from_file(path)
        gt_path = config.TASK_CONFIG.TASK.NDTW.GT_PATH.format(split=split)
        gt = {}
        if os.path.exists(gt_path):
            with gzip.open(gt_path, "rt") as f:
                gt = json.load(f)
        return ds, gt
    n = config.TASK_CONFIG.DATASET.FAKE_EPISODES
    n_scenes = config.TASK_CONFIG.DATASET.FAKE_SCENES
    scenes = [f"fake/{split}_{i}" for i in range(n_scenes)]
    # zlib.crc32, not hash(): str hash is salted per process, which would
    # give every run — and every distributed RANK — a different episode
    # set for the same split
    ds = make_fake_dataset(
        num_episodes=n, scenes=scenes,
        seed=(zlib.crc32(split.encode())
              + config.TASK_CONFIG.DATASET.FAKE_SEED_OFFSET) % 1000,
        min_geodesic=config.TASK_CONFIG.DATASET.FAKE_MIN_GEODESIC,
        max_geodesic=config.TASK_CONFIG.DATASET.FAKE_MAX_GEODESIC)
    return ds, fake_gt_locations(ds)
