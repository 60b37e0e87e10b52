"""Seeded inputs for the card drives (``chip_smoke.py`` and the profile
tool): a full-width policy with random weights and "wall ahead"
observations."""
from __future__ import annotations

import numpy as np
import torch

from ws_mgmap_tpu_torch.models.policy import BasePolicy, MGMapConfig
from ws_mgmap_tpu_torch.ops.mapping import MapperParams


def random_policy(seed: int, rotate_in_splat: bool) -> BasePolicy:
    """The reference geometry at width 1 (224^2 RGB, 100^2 ego and 240^2
    global maps, 64 channels), torch's default init from ``seed`` and
    non-trivial BN statistics, with positive BN shifts so the features are
    mostly non-zero after each ReLU."""
    torch.manual_seed(seed)
    policy = BasePolicy(MGMapConfig(
        mapper=MapperParams(rotate_in_splat=rotate_in_splat)))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in policy.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=gen) * 0.5 + 0.5)
                m.bias.copy_(torch.rand(n, generator=gen) * 0.25 + 0.05)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.05)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return policy


def wall_obs(b: int, compass: float, rng: np.random.RandomState,
             depth: float = 0.3) -> list[dict]:
    """Raw observations of ``b`` agents at the origin facing a wall
    ``depth`` * 10 m ahead (habitat depth is meters / 10), random RGB."""
    return [{
        "instruction": np.arange(1, 9),
        "rgb": rng.randint(0, 255, (224, 224, 3)).astype(np.float32),
        "depth": np.full((256, 256, 1), depth, np.float32),
        "gps": np.zeros(2, np.float32),
        "compass": np.array([compass], np.float32),
    } for _ in range(b)]
