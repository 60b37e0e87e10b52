"""Checkpoint evaluation: full rollout loop against the env backend.

Port of ``ws_mgmap_tpu/train/evaluator.py``, which re-provides
`CommonTrainer._eval_checkpoint` (`common_trainer.py:228-506`):
auto-reset-false envs, forced oracle actions during the 24-step look-around
spin, a policy decision every `step_num` steps, progress-threshold stopping
inside the env, pause-on-finished episodes, metric aggregation + JSON dumps.
The engine is the port's ``RolloutEngine``; its outputs come back to the
host with ``.cpu().numpy()``. With ``VIDEO_OPTION`` each env's frames
(``env/viz.py``) are kept in a buffer of its own and written as its
episode ends, up to ``VIDEO_NUM`` videos.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ws_mgmap_tpu_torch.env import viz
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
    tb_writer=None,
    envs=None,
) -> Dict[str, float]:
    """Evaluate one checkpoint's engine over the split. ``envs`` is a
    vector env already built over it (``construct_envs`` with
    ``auto_reset_done=False``); by default the loop builds one, with env
    workers when ``workers``. The loop closes it. Videos go to
    ``config.VIDEO_DIR`` and, with "tensorboard" in ``VIDEO_OPTION``, to
    ``tb_writer``."""
    episode_count = episode_count or config.EVAL.EPISODE_COUNT
    if envs is None:
        envs = construct_envs(config, dataset, gt_locations,
                              auto_reset_done=False, workers=workers)
    try:
        videos = _Videos(config, checkpoint_index, tb_writer)
        stats_episodes = _rollout(config, engine, envs, episode_count,
                                  videos)
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


class _Videos:
    """The eval videos' frames. Buffers are keyed by a stable slot, not
    by the env's current index: ``pause_at`` re-indexes the envs, and
    ``slots[i]`` is the buffer of current env ``i``. The predicted map and
    the attention of the last decision are kept per current env too, and
    re-indexed with it. (The JAX package keeps them by batch row across
    pauses and rounds, so that after a pause a frame can show another
    env's maps.) Off when ``VIDEO_OPTION`` is empty."""

    def __init__(self, config, checkpoint_index: int, tb_writer=None):
        self.on = bool(config.VIDEO_OPTION)
        self.option = list(config.VIDEO_OPTION)
        self.dir = config.VIDEO_DIR
        self.limit = getattr(config, "VIDEO_NUM", 99999)
        self.checkpoint_index = checkpoint_index
        self.tb_writer = tb_writer
        self.written = 0

    def reset(self, n: int) -> None:
        """Fresh episodes in every slot: fresh buffers, no decision yet."""
        self.frames: List[List[np.ndarray]] = [[] for _ in range(n)]
        self.slots = list(range(n))
        self.att = self.pred = None

    def decided(self, out) -> None:
        if self.on:
            self.att = out.att_map.float().cpu().numpy()
            self.pred = out.pred_sem_map.float().cpu().numpy()

    def add_frames(self, observations, infos, episodes) -> None:
        """One frame per env: its observation after the step, the last
        decision's maps and the instruction of the episode it stepped."""
        if not self.on or self.written >= self.limit:
            return
        for i, obs in enumerate(observations):
            frame = viz.observations_to_image(
                obs, att_map=None if self.att is None else self.att[i],
                pred_sem_map=None if self.pred is None else self.pred[i],
                info=infos[i])
            frame = viz.append_text_to_image(
                frame, episodes[i].instruction.get("instruction_text", ""))
            self.frames[self.slots[i]].append(frame)

    def episode_done(self, i: int, episode, info) -> None:
        if not self.on or self.written >= self.limit:
            return
        slot = self.slots[i]
        viz.generate_video(
            self.dir, self.frames[slot], episode_id=episode.episode_id,
            checkpoint_idx=self.checkpoint_index,
            metrics={"spl": info.get("spl", 0.0)},
            video_option=self.option, tb_writer=self.tb_writer)
        self.frames[slot] = []
        self.written += 1

    def keep(self, keep: Sequence[int]) -> None:
        self.slots = [self.slots[i] for i in keep]
        if self.att is not None:
            self.att, self.pred = self.att[keep], self.pred[keep]


def _rollout(config, engine, envs, episode_count: int, videos: _Videos
             ) -> Dict[str, Dict[str, float]]:
    """The loop: every env steps until ``episode_count`` distinct
    episodes have ended; returns each episode's final measures."""
    n0 = envs.num_envs
    engine.reset_state(n0)
    videos.reset(n0)

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
            videos.decided(out)
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

        videos.add_frames(observations, infos, current_episodes)
        for i in range(envs.num_envs):
            if dones[i]:
                stats_episodes[current_episodes[i].episode_id] = infos[i]
                videos.episode_done(i, current_episodes[i], infos[i])

        if all(dones):
            # resume + full state reset (`common_trainer.py:412-437`)
            envs.resume_all()
            observations = envs.reset()
            engine.reset_state(envs.num_envs)
            masks = np.zeros((envs.num_envs, 1), np.float32)
            count_step = 0
            actions = np.zeros((envs.num_envs, 2), np.float32)
            videos.reset(envs.num_envs)

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
            videos.keep(keep)
            batch = engine.batch_obs(observations) if keep else batch
            if envs.num_envs == 0:
                break
    return stats_episodes
