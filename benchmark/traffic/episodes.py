"""Seeded episode schedules: instructions, rollout episode lengths and
replay episodes for teacher forcing.

Every seed draws the same set of sizes (episode lengths, instruction
lengths) in another order, so that seeds change which work comes when,
not how much of it there is.
"""
from __future__ import annotations

import numpy as np
import torch


def size_set(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` integers spread evenly over [lo, hi]."""
    return np.linspace(lo, hi, n).round().astype(np.int64)


def instruction(rng: np.random.Generator, words: int, vocab: int,
                length: int) -> np.ndarray:
    """[length] int32: ``words`` ids uniform in [1, vocab), then 0-pads."""
    out = np.zeros(length, np.int32)
    out[:words] = rng.integers(1, vocab, words)
    return out


class RolloutEpisodes:
    """Each env slot's endless run of episodes: lengths from the set
    ``size_set(*episode_steps, cycle)`` and instruction word counts from
    ``size_set(*instruction_words, cycle)``, both permuted per env and
    per cycle by the seed."""

    def __init__(self, seed: int, env: int, traffic: dict, vocab: int,
                 length: int):
        self.rng = np.random.default_rng([seed, 2, env])
        self.traffic, self.vocab, self.length = traffic, vocab, length
        self.count = 0
        self._lengths: list[int] = []
        self._words: list[int] = []

    def next(self) -> tuple[int, np.ndarray, int]:
        """(length in engine steps, tokens, episode number)."""
        t = self.traffic
        if not self._lengths:
            n = t["size_cycle"]
            self._lengths = list(self.rng.permutation(
                size_set(*t["episode_steps"], n)))
            self._words = list(self.rng.permutation(
                size_set(*t["instruction_words"], n)))
        tokens = instruction(self.rng, int(self._words.pop()), self.vocab,
                             self.length)
        self.count += 1
        return int(self._lengths.pop()), tokens, self.count - 1


def replay_lengths(seed: int, traffic: dict) -> np.ndarray:
    """The replay episodes' lengths in subsampled steps, in store order."""
    rng = np.random.default_rng([seed, 3])
    return rng.permutation(size_set(*traffic["episode_steps"],
                                    traffic["episodes"]))


def replay_episodes(seed: int, traffic: dict, cfg: dict, device
                    ) -> list[dict]:
    """Replay episodes as the collector stores them (the trainer's record
    layout, narrowed dtypes): per step the cached UNet bottleneck
    ``rgb_features`` [7, 7, 512], the depth trunk's ``depth_features``
    [s, s, 128], the ego map ``rgb_ego_map`` [E, E, C] (non-negative, 70%
    of cells empty), the monitor targets ``gt_semantic_map`` and
    ``gt_path`` [E, E], ``progress``, the oracle ``waypoint``, and one
    instruction per episode. Bulk values come from a generator on
    ``device``."""
    rng = np.random.default_rng([seed, 4])
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    e, c = cfg["ego_map_size"], cfg["map_depth"]
    s = cfg["depth_spatial"]
    rgb_c = max(8, int(512 * cfg["unet_width"]))
    vocab, length = cfg["vocab_size"], cfg["instruction_len"]
    words = size_set(*traffic["instruction_words"], traffic["episodes"])
    words = rng.permutation(words)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    out = []
    for n, w in zip(replay_lengths(seed, traffic), words):
        n = int(n)
        ego = rand(n, e, e, c)
        ego = torch.where(rand(n, e, e, 1) < 0.7, 0.0, ego)
        tokens = instruction(rng, int(w), vocab, length).astype(np.int64)
        obs = {
            "instruction": np.tile(tokens, (n, 1)),
            "rgb_features": randn(n, 7, 7, rgb_c).clamp(min=0).half(),
            "depth_features": randn(n, s, s, 128).clamp(min=0).half(),
            "rgb_ego_map": ego.half(),
            "gt_semantic_map": torch.randint(
                0, cfg["num_classes"], (n, e, e), generator=gen,
                device=device, dtype=torch.int32),
            "gt_path": (rand(n, e, e) * 50).half(),
            "waypoint": rand(n, 2) * 1.8 - 0.9,
            "progress": torch.linspace(0, 1, n, device=device)[:, None],
        }
        obs = {k: v if isinstance(v, np.ndarray) else v.cpu().numpy()
               for k, v in obs.items()}
        prev = (rand(n, 2) * 2 - 1).cpu().numpy()
        out.append({"obs": obs, "prev_actions": prev,
                    "oracle_actions": obs["waypoint"].copy()})
    return out
