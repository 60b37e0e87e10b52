"""A cell's files at a size a CPU test can hold: the configuration with
the widths of the repository's small end-to-end config, the traffic cut
to 2 envs and short episodes, a run context on the CPU."""
from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from benchmark import harness

TINY = {"rgb_hw": 64, "depth_hw": 128, "unet_width": 0.125,
        "depth_spatial": 2, "map_depth": 16, "global_map_size": 48,
        "ego_map_size": 20, "map_output_size": 32, "rgb_output_size": 32,
        "depth_output_size": 16, "hidden_size": 64, "instr_hidden": 16}
ROLLOUT = dict(envs=2, episode_steps=[6, 12], sample_span=18, samples=2,
               warmup_cycles=1, profile_cycles=2)
TRAIN = dict(episodes=6, episode_steps=[3, 9], batch_size=2,
             profile_updates=1)


def cell(name: str) -> tuple[dict, dict]:
    workload = copy.deepcopy(harness.load_json("workloads", name))
    cfg = dict(harness.load_json("configs", workload["config"]), **TINY)
    workload["traffic"].update(ROLLOUT if workload["driver"] == "rollout"
                               else TRAIN)
    return workload, cfg


def ctx(name: str, tmp: Path, seed: int = 2 ** 31 + 11,
        seconds: float = 1.0, trace: bool = False) -> harness.Ctx:
    workload, cfg = cell(name)
    torch.set_num_threads(2)
    return harness.Ctx(name, workload, cfg, seed, seconds, trace,
                       torch.device("cpu"), tmp, time.time())


def run(name: str, tmp: Path, **kw) -> harness.Outcome:
    c = ctx(name, tmp, **kw)
    return harness.import_file("drivers", c.workload["driver"]).run(c)
