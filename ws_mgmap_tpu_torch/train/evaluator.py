"""Checkpoint evaluation: full rollout loop against the env backend.

Port of ``ws_mgmap_tpu/train/evaluator.py``, which re-provides
`CommonTrainer._eval_checkpoint` (`common_trainer.py:228-506`):
auto-reset-false envs, forced oracle actions during the 24-step look-around
spin, a policy decision every `step_num` steps, progress-threshold stopping
inside the env, pause-on-finished episodes, metric aggregation + JSON dumps.
The engine is the port's ``RolloutEngine``; its outputs come back to the
host with ``.cpu().numpy()``. Eval videos (``VIDEO_OPTION``, the JAX
package's ``env/viz.py``) are not ported: the loop raises when they are
asked for.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ws_mgmap_tpu_torch.env.vector_env import construct_envs
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine


def evaluate(
    config,
    engine: RolloutEngine,
    dataset,
    gt_locations,
    episode_count: Optional[int] = None,
    workers: bool = True,
    log_fn=print,
    metric_dir: Optional[str] = None,
    checkpoint_index: int = 0,
    split: str = "val_seen",
    envs=None,
) -> Dict[str, float]:
    """Evaluate one checkpoint's engine over the split. ``envs`` is a
    vector env already built over it (``construct_envs`` with
    ``auto_reset_done=False``); by default the loop builds one, with env
    workers when ``workers``. The loop closes it."""
    if config.VIDEO_OPTION:
        raise NotImplementedError(
            f"VIDEO_OPTION {list(config.VIDEO_OPTION)}: eval videos "
            "(env/viz.py) are not ported")
    episode_count = episode_count or config.EVAL.EPISODE_COUNT
    if envs is None:
        envs = construct_envs(config, dataset, gt_locations,
                              auto_reset_done=False, workers=workers)
    try:
        stats_episodes = _rollout(config, engine, envs, episode_count)
    finally:
        envs.close()

    agg: Dict[str, float] = {}
    if stats_episodes:
        keys = next(iter(stats_episodes.values())).keys()
        finite = lambda vals: [v for v in vals if np.isfinite(v)]
        for k in keys:
            vals = finite([s[k] for s in stats_episodes.values()])
            agg[k] = float(np.mean(vals)) if vals else float("nan")
    log_fn(f"[eval] {len(stats_episodes)} episodes: "
           + ", ".join(f"{k}={v:.3f}" for k, v in agg.items()))

    if metric_dir:
        os.makedirs(metric_dir, exist_ok=True)
        with open(os.path.join(
                metric_dir, f"stats_ckpt_{checkpoint_index}_{split}.json"),
                "w") as f:
            json.dump(agg, f, indent=4)
        with open(os.path.join(
                metric_dir, f"each_stat_ckpt_{checkpoint_index}_{split}.json"),
                "w") as f:
            json.dump({k: {kk: float(vv) for kk, vv in v.items()}
                       for k, v in stats_episodes.items()}, f)
    return agg


def _rollout(config, engine, envs, episode_count: int
             ) -> Dict[str, Dict[str, float]]:
    """The loop: every env steps until ``episode_count`` distinct
    episodes have ended; returns each episode's final measures."""
    n0 = envs.num_envs
    engine.reset_state(n0)

    observations = envs.reset()
    batch = engine.batch_obs(observations)
    masks = np.zeros((n0, 1), np.float32)
    stats_episodes: Dict[str, Dict[str, float]] = {}
    count_step = 0
    actions = np.zeros((envs.num_envs, 2), np.float32)

    while envs.num_envs > 0 and len(stats_episodes) < episode_count:
        current_episodes = envs.current_episodes()

        # decision protocol (`common_trainer.py:327-338`)
        if count_step % config.step_num == 0 and count_step >= 24:
            out = engine.act(batch, masks)
            actions = out.action.cpu().numpy()
        else:
            engine.update_map(batch, masks)
        if count_step < 24:
            # oracle waypoint during the spin (`common_trainer.py:337-338`)
            actions = np.stack([np.asarray(o["waypoint"], np.float32)[:2]
                                for o in observations])

        prog = engine.prog
        step_inputs = [
            {
                "action": actions[e],
                "prog": float(prog[e, 0]) if count_step >= 24 else -1,
                "epidsode_reset_flag": count_step == 0,
                "depth_img": observations[e]["depth"],
            }
            for e in range(envs.num_envs)
        ]
        outputs = envs.step(step_inputs)
        observations = [o[0] for o in outputs]
        dones = [o[2] for o in outputs]
        infos = [o[3] for o in outputs]
        count_step += 1
        masks = np.array([[0.0] if d else [1.0] for d in dones], np.float32)

        for i in range(envs.num_envs):
            if dones[i]:
                stats_episodes[current_episodes[i].episode_id] = infos[i]

        if all(dones):
            # resume + full state reset (`common_trainer.py:412-437`)
            envs.resume_all()
            observations = envs.reset()
            engine.reset_state(envs.num_envs)
            masks = np.zeros((envs.num_envs, 1), np.float32)
            count_step = 0
            actions = np.zeros((envs.num_envs, 2), np.float32)

        batch = engine.batch_obs(observations)

        # pause envs whose next episode is already evaluated
        # (`common_trainer.py:447-476`)
        next_episodes = envs.current_episodes()
        envs_to_pause = [i for i in range(envs.num_envs)
                         if next_episodes[i].episode_id in stats_episodes]
        if envs_to_pause:
            keep = [i for i in range(envs.num_envs) if i not in envs_to_pause]
            for i in reversed(envs_to_pause):
                envs.pause_at(i)
            engine.keep(keep)
            observations = [observations[i] for i in keep]
            masks = masks[keep]
            actions = actions[keep]
            batch = engine.batch_obs(observations) if keep else batch
            if envs.num_envs == 0:
                break
    return stats_episodes
