"""Seeded inputs for the card drives (``chip_smoke.py`` and the profile
tool): a full-width policy with random weights, instructions, "wall
ahead" observations and replay episodes for the training step; and the
small end-to-end configuration of the CPU tests (:data:`TINY_OPTS`)."""
from __future__ import annotations

import numpy as np
import torch

from ws_mgmap_tpu_torch.models.policy import BasePolicy, MGMapConfig
from ws_mgmap_tpu_torch.ops.mapping import MapperParams


def random_policy(seed: int, rotate_in_splat: bool) -> BasePolicy:
    """The whole policy at the reference's widths (``MGMapConfig``'s
    defaults: 224^2 RGB, 256^2 depth, 100^2 ego and 240^2 global maps with
    64 channels, vocab 2504, hidden 512), torch's default init from
    ``seed`` and non-trivial BN statistics, with positive BN shifts so the
    features are mostly non-zero after each ReLU."""
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


def instruction_tokens(b: int, rng: np.random.RandomState,
                       length: int = 200, vocab: int = 2504) -> np.ndarray:
    """[b, length] int32 instructions: 20-120 word ids in [1, vocab) each,
    then 0-padding."""
    out = np.zeros((b, length), np.int32)
    for i, n in enumerate(rng.randint(20, 121, b)):
        out[i, :n] = rng.randint(1, vocab, n)
    return out


def wall_obs(b: int, compass: float, rng: np.random.RandomState,
             depth: float = 0.3, tokens: np.ndarray | None = None
             ) -> list[dict]:
    """Raw observations of ``b`` agents at the origin facing a wall
    ``depth`` * 10 m ahead (habitat depth is meters / 10), random RGB, and
    ``tokens`` [b, L] as the instructions (drawn from ``rng`` by
    :func:`instruction_tokens` when None)."""
    if tokens is None:
        tokens = instruction_tokens(b, rng)
    return [{
        "instruction": tokens[i],
        "rgb": rng.randint(0, 255, (224, 224, 3)).astype(np.float32),
        "depth": np.full((256, 256, 1), depth, np.float32),
        "gps": np.zeros(2, np.float32),
        "compass": np.array([compass], np.float32),
    } for i in range(b)]


# the training cell: DAGGER.BATCH_SIZE = 5 episodes of 20-59 subsampled
# steps, one of exactly 59, so T = 64 after the 16-step bucket (320 frames)
TRAIN_LENGTHS = (59, 20, 37, 48, 26)


def train_episodes(rng: np.random.RandomState, lengths,
                   cfg: MGMapConfig = MGMapConfig()) -> list[dict]:
    """Replay episodes of the given lengths (subsampled steps) as the
    trainer stores them: per step the cached UNet bottleneck
    (``rgb_features`` [7, 7, 512]) and depth trunk output
    (``depth_features`` [4, 4, 128]), the ego map (``rgb_ego_map`` [E, E,
    64], non-negative with most cells empty), the monitor targets
    (``gt_semantic_map``, ``gt_path`` [E, E]; ``progress``), the oracle
    ``waypoint``, and one instruction per episode (200 tokens, 20-120
    words), float16 where the trainer narrows. E is ``cfg.ego_map_size``;
    the feature widths follow ``cfg`` too."""
    e, d = cfg.ego_map_size, cfg.map_depth
    out = []
    for n, tokens in zip(lengths, instruction_tokens(len(lengths), rng,
                                                     vocab=cfg.vocab_size)):
        ego = rng.rand(n, e, e, d).astype(np.float16)
        ego[rng.rand(n, e, e) < 0.7] = 0.0
        out.append({
            "obs": {
                "instruction": np.tile(tokens, (n, 1)),
                "rgb_features": np.maximum(
                    rng.randn(n, 7, 7, max(8, int(512 * cfg.unet_width))),
                    0).astype(np.float16),
                "depth_features": np.maximum(
                    rng.randn(n, cfg.depth_spatial, cfg.depth_spatial,
                              128), 0).astype(np.float16),
                "rgb_ego_map": ego,
                "gt_semantic_map": rng.randint(0, cfg.num_classes,
                                               (n, e, e)).astype(np.int32),
                "gt_path": (rng.rand(n, e, e) * 50).astype(np.float16),
                "waypoint": rng.uniform(-0.9, 0.9, (n, 2)).astype(np.float32),
                "progress": np.linspace(0, 1, n, dtype=np.float32)[:, None],
            },
            "prev_actions": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
        })
    return out


def special_splat_inputs(rng: np.random.RandomState, p: int, c: int,
                         ego: int) -> tuple[np.ndarray, np.ndarray]:
    """Two frames of splat operands (feats [2, p, c] fp32, ids [2, p]
    int32) whose first frame puts edge values on cells 0-8 and random
    finite ones on the other cells, and whose second frame is all invalid.
    Cell 0: a NaN in channel 0; 1: a negative NaN and +inf in channel 1;
    2: +inf; 3: +0.0 and -0.0; 4: -0.0 only; 5: maxima below -1e16; 6:
    -inf only; 7: exactly -1e16; 8: -9.9e15. Needs c >= 3 and p >= 64."""
    feats = (rng.randn(2, p, c) * 2.0).astype(np.float32)
    ids = rng.randint(9, ego * ego, (2, p)).astype(np.int32)
    ids[rng.rand(2, p) < 0.5] = -1
    ids[1] = -1
    cases = [(0, {0: np.nan}), (0, {}), (1, {1: -np.nan}), (1, {1: np.inf}),
             (2, {2: np.inf}), (2, {}), (3, "+0"), (3, "-0"), (4, "-0"),
             (4, "-0"), (5, -2e16), (5, -3e16), (6, -np.inf), (7, -1e16),
             (8, -9.9e15)]
    neg_nan = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    for k, (cell, val) in enumerate(cases):
        q = 4 * k + 1  # scattered over the frame, never adjacent
        ids[0, q] = cell
        if isinstance(val, dict):
            for ch, v in val.items():
                feats[0, q, ch] = neg_nan if (np.isnan(v) and
                                              np.signbit(v)) else v
        elif val == "+0":
            feats[0, q] = 0.0
        elif val == "-0":
            feats[0, q] = -0.0
        else:
            feats[0, q] = val
    return feats, ids


# The small end-to-end run of the CPU tests, as trailing options of the
# command line: the JAX tests' ``tiny_config`` (2 envs, 1 DAgger iteration
# of 1 epoch over 2 episodes at beta 1, 4 FakeSim episodes on 2 scenes of
# at most 60 steps, 64^2 RGB, a 20^2 ego map, a thin policy), with the
# port tests' UNet width 0.125 and 128^2 depth (a 2x2 depth trunk).
TINY_OPTS = [
    "NUM_PROCESSES", "2",
    "DAGGER.ITERATIONS", "1", "DAGGER.EPOCHS", "1",
    "DAGGER.UPDATE_SIZE", "2", "DAGGER.BATCH_SIZE", "2", "DAGGER.P", "1.0",
    "EVAL.EPISODE_COUNT", "2", "EVAL.SPLIT", "val_seen",
    "ep_max_len", "60", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "60",
    "TASK_CONFIG.DATASET.FAKE_EPISODES", "4",
    "TASK_CONFIG.DATASET.FAKE_SCENES", "2",
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", "64",
    "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", "64",
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", "128",
    "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", "128",
    "MODEL.DEPTH_ENCODER.spatial_hw", "2",
    "MODEL.RGB_ENCODER.unet_width", "0.125",
    "MODEL.RGBMAPPING.map_depth", "16",
    "MODEL.RGBMAPPING.global_map_size", "48",
    "MODEL.RGBMAPPING.egocentric_map_size", "20",
    "MODEL.MAP_ENCODER.ego_map_size", "20",
    "MODEL.MAP_ENCODER.output_size", "32",
    "MODEL.RGB_ENCODER.output_size", "32",
    "MODEL.DEPTH_ENCODER.output_size", "16",
    "MODEL.STATE_ENCODER.hidden_size", "64",
    "MODEL.INSTRUCTION_ENCODER.hidden_size", "16",
]


def tiny_config(tmp_dir: str, opts=()):
    """The port's config with :data:`TINY_OPTS` and then ``opts``, its
    store, checkpoints and TensorBoard under ``tmp_dir``."""
    import os

    from ws_mgmap_tpu_torch.config.default import get_config

    cfg = get_config(opts=TINY_OPTS + list(opts))
    cfg.defrost()
    cfg.DAGGER.LMDB_FEATURES_DIR = os.path.join(tmp_dir, "traj")
    cfg.CHECKPOINT_FOLDER = os.path.join(tmp_dir, "ckpt")
    cfg.TENSORBOARD_DIR = os.path.join(tmp_dir, "tb")
    cfg.freeze()
    return cfg
