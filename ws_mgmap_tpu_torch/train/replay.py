"""Episode records -> episode-major training batches.

The port's copy of ``collate_episodes`` from ``ws_mgmap_tpu/train/replay.py``
(plain numpy), so that tests and ``chip_smoke.py`` build batches exactly as
the trainer does. The replay loader and the trajectory store, which
belong to the trainer's data pipeline, are not ported yet.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np


def collate_episodes(episodes: Sequence[dict[str, Any]],
                     max_len: int = 200,
                     t_bucket: int = 16,
                     fixed_len: bool = False) -> dict[str, Any]:
    """Pad and stack episodes to [N, T, ...].

    Each episode is {"obs": {key: [len, ...]}, "prev_actions": [len, 2],
    ...}. T is the longest episode rounded up to a multiple of
    ``t_bucket`` and capped at ``max_len`` (``max_len`` itself with
    ``fixed_len``). Observations are padded with 1.0, as the reference
    does (padded frames carry instructions of token 1 at every position),
    and float16 ones come back as float32. Returns {"obs": {...},
    "prev_actions": [N, T, 2], "weights": [N, T] (0 on padding),
    "not_done_masks": [N, T] (0 at t=0)}.
    """
    n = len(episodes)
    if fixed_len:
        t_max = max_len
    else:
        t_max = min(max(e["prev_actions"].shape[0] for e in episodes), max_len)
        if t_bucket > 1:
            t_max = min(-(-t_max // t_bucket) * t_bucket, max_len)

    def pad_stack(key_fn, fill):
        rows = []
        for e in episodes:
            arr = np.asarray(key_fn(e))[:t_max]
            if arr.shape[0] < t_max:
                pad_shape = (t_max - arr.shape[0],) + arr.shape[1:]
                arr = np.concatenate(
                    [arr, np.full(pad_shape, fill, arr.dtype)], axis=0)
            rows.append(arr)
        return np.stack(rows)

    obs = {}
    for k in episodes[0]["obs"]:
        stacked = pad_stack(lambda e, k=k: e["obs"][k], 1.0)
        if stacked.dtype == np.float16:
            stacked = stacked.astype(np.float32)
        obs[k] = stacked
    prev_actions = pad_stack(lambda e: e["prev_actions"], 0.0)
    weights = np.zeros((n, t_max), np.float32)
    for i, e in enumerate(episodes):
        weights[i, :min(e["prev_actions"].shape[0], t_max)] = 1.0
    masks = np.ones((n, t_max), np.float32)
    masks[:, 0] = 0.0
    return {
        "obs": obs,
        "prev_actions": prev_actions,
        "weights": weights,
        "not_done_masks": masks,
    }
