"""The traffic generators: the same seed gives the same inputs, and the
sizes keep to the parameters' ranges."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.traffic import episodes, rooms
from benchmark.tests import tiny

BIG_SEED = 2 ** 31 + 12345


def rollout_traffic() -> dict:
    return harness.load_json("workloads", "fp32_rollout_b5")["traffic"]


def test_rollout_episodes_deterministic_and_in_range():
    t = rollout_traffic()

    def draw(seed):
        eps = episodes.RolloutEpisodes(seed, 3, t, 2504, 200)
        return [eps.next() for _ in range(40)]

    a, b = draw(BIG_SEED), draw(BIG_SEED)
    assert [x[0] for x in a] == [x[0] for x in b]
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    lo, hi = t["episode_steps"]
    wlo, whi = t["instruction_words"]
    for length, tokens, _ in a:
        assert lo <= length <= hi
        words = int((tokens != 0).sum())
        assert wlo <= words <= whi
        assert tokens.shape == (200,) and tokens.dtype == np.int32
        assert (tokens[:words] >= 1).all() and (tokens[:words] < 2504).all()
        assert (tokens[words:] == 0).all()
    # every seed draws the same set of sizes, in another order
    c = draw(BIG_SEED + 1)
    n = t["size_cycle"]
    assert sorted(x[0] for x in a[:n]) == sorted(x[0] for x in c[:n])
    assert [x[0] for x in a[:n]] != [x[0] for x in c[:n]]


def test_frame_pool_deterministic_and_physical(tmp_path):
    t = rollout_traffic()

    def pool(seed):
        return rooms.FramePool(seed, 2, 1, 30, t, 32, 64, torch.device("cpu"))

    a, b = pool(BIG_SEED), pool(BIG_SEED)
    assert np.array_equal(a.depth, b.depth) and np.array_equal(a.rgb, b.rgb)
    assert np.array_equal(a.gps, b.gps)
    assert not np.array_equal(a.depth, pool(BIG_SEED + 1).depth)
    assert a.depth.shape == (60, 64, 64, 1) and a.rgb.dtype == np.uint8
    assert (a.depth > 0).all() and (a.depth <= 1).all()
    # the floor lies under the horizon: the bottom row is nearer than 4 m
    assert (a.depth[:, -1] * 10 < 4).all()
    # the look-around turns in place: no GPS motion in the first 24 steps
    first = a.index(0, 0, 0)
    assert np.allclose(a.gps[first:first + 24], 0)
    assert np.abs(a.gps[first + 29]).sum() > 0


def test_replay_episodes_deterministic_and_in_range():
    workload, cfg = tiny.cell("fp32_train_n8")
    t = workload["traffic"]
    a = episodes.replay_episodes(BIG_SEED, t, cfg, torch.device("cpu"))
    b = episodes.replay_episodes(BIG_SEED, t, cfg, torch.device("cpu"))
    assert len(a) == t["episodes"]
    lo, hi = t["episode_steps"]
    for x, y in zip(a, b):
        n = x["prev_actions"].shape[0]
        assert lo <= n <= hi
        for k in x["obs"]:
            assert np.array_equal(x["obs"][k], y["obs"][k])
            assert x["obs"][k].shape[0] == n
        tokens = x["obs"]["instruction"][0]
        words = int((tokens != 0).sum())
        assert t["instruction_words"][0] <= words <= t["instruction_words"][1]
        ego = x["obs"]["rgb_ego_map"]
        assert ego.dtype == np.float16 and (ego >= 0).all()
    full = harness.load_json("workloads", "fp32_train_n8")["traffic"]
    lengths = episodes.replay_lengths(BIG_SEED, full)
    assert len(lengths) == 24 and lengths.min() == 20 and lengths.max() == 59


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 40 + 3])
def test_large_seeds_accepted(seed):
    eps = episodes.RolloutEpisodes(seed, 0, rollout_traffic(), 2504, 200)
    assert eps.next()[0] >= 48
