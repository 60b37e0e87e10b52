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

:func:`rollout` is the port's one eval loop: inference
(``DaggerTrainer.inference``) and ``tools/diag_policy_probe.py`` run it
too, each with an :class:`EvalObserver` of its own.
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
        stats_episodes = rollout(config, engine, envs, episode_count,
                                 _Videos(config, checkpoint_index, tb_writer))
    finally:
        envs.close()

    agg: Dict[str, float] = {}
    for k in next(iter(stats_episodes.values()), {}):
        vals = [s[k] for s in stats_episodes.values() if np.isfinite(s[k])]
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


class EvalObserver:
    """A caller's view of :func:`rollout`. Row ``i`` is an env's place in
    the batch, which shrinks as envs pause. Each hook does nothing here."""

    def reset(self, n: int) -> None:
        """Fresh episodes in all ``n`` rows: each round's start."""

    def decided(self, out, observations, count_step: int) -> None:
        """After each ``engine.act``, with the observations it saw."""

    def stepped(self, observations, infos, episodes) -> None:
        """After each ``envs.step``, before any ``episode_done``."""

    def episode_done(self, i: int, episode, info) -> None:
        """Row ``i`` ended ``episode``; ``info``: its final measures."""

    def keep(self, keep: Sequence[int]) -> None:
        """Only the rows ``keep`` go on, in that order."""


class _Videos(EvalObserver):
    """The eval videos' frames, a buffer per row, re-indexed with the
    rows as envs pause, as are the predicted map and the attention of the
    last decision. (The JAX package keeps the maps by batch row across
    pauses and rounds, so that after a pause a frame can show another
    env's maps.) Off when ``VIDEO_OPTION`` is empty."""

    def __init__(self, config, checkpoint_index: int, tb_writer=None):
        self.option = list(config.VIDEO_OPTION)
        self.dir = config.VIDEO_DIR
        self.limit = getattr(config, "VIDEO_NUM", 99999) if self.option else 0
        self.checkpoint_index = checkpoint_index
        self.tb_writer = tb_writer
        self.written = 0

    def reset(self, n: int) -> None:
        self.frames: List[List[np.ndarray]] = [[] for _ in range(n)]
        self.att = self.pred = None

    def decided(self, out, observations, count_step: int) -> None:
        if self.written < self.limit:
            self.att = out.att_map.float().cpu().numpy()
            self.pred = out.pred_sem_map.float().cpu().numpy()

    def stepped(self, observations, infos, episodes) -> None:
        """One frame per env: its observation after the step, the last
        decision's maps and the instruction of the episode it stepped."""
        if self.written >= self.limit:
            return
        for i, obs in enumerate(observations):
            frame = viz.observations_to_image(
                obs, att_map=None if self.att is None else self.att[i],
                pred_sem_map=None if self.pred is None else self.pred[i],
                info=infos[i])
            self.frames[i].append(viz.append_text_to_image(
                frame, episodes[i].instruction.get("instruction_text", "")))

    def episode_done(self, i: int, episode, info) -> None:
        if self.written >= self.limit:
            return
        viz.generate_video(
            self.dir, self.frames[i], episode_id=episode.episode_id,
            checkpoint_idx=self.checkpoint_index,
            metrics={"spl": info.get("spl", 0.0)},
            video_option=self.option, tb_writer=self.tb_writer)
        self.frames[i] = []
        self.written += 1

    def keep(self, keep: Sequence[int]) -> None:
        self.frames = [self.frames[i] for i in keep]
        if self.att is not None:
            self.att, self.pred = self.att[keep], self.pred[keep]


def rollout(config, engine, envs, episode_count: int,
            observer: EvalObserver) -> Dict[str, Dict[str, float]]:
    """The eval loop: every env steps until ``episode_count`` distinct
    episodes have ended; returns each episode's final measures. An env
    whose next episode has already ended pauses; when every env has
    ended its episode, all resume on fresh ones."""
    stats_episodes: Dict[str, Dict[str, float]] = {}
    dones = [True]  # the first round starts as every later one
    while True:
        if all(dones):
            # resume + full state reset (`common_trainer.py:412-437`)
            envs.resume_all()
            observations = envs.reset()
            engine.reset_state(envs.num_envs)
            observer.reset(envs.num_envs)
            masks = np.zeros((envs.num_envs, 1), np.float32)
            actions = np.zeros((envs.num_envs, 2), np.float32)
            count_step = 0

        # pause envs whose next episode has already ended
        # (`common_trainer.py:447-476`)
        episodes = envs.current_episodes()
        keep = [i for i, e in enumerate(episodes)
                if e.episode_id not in stats_episodes]
        for i in reversed(range(len(episodes))):
            if i not in keep:
                envs.pause_at(i)
        if not keep or len(stats_episodes) >= episode_count:
            return stats_episodes
        if len(keep) < len(episodes):
            engine.keep(keep)
            observer.keep(keep)
            episodes = [episodes[i] for i in keep]
            observations = [observations[i] for i in keep]
            masks, actions = masks[keep], actions[keep]
        batch = engine.batch_obs(observations)

        # decision protocol (`common_trainer.py:327-338`)
        if count_step % config.step_num == 0 and count_step >= 24:
            out = engine.act(batch, masks)
            actions = out.action.cpu().numpy()
            observer.decided(out, observations, count_step)
        else:
            engine.update_map(batch, masks)
        if count_step < 24:
            # oracle waypoint during the spin (`common_trainer.py:337-338`)
            actions = np.stack([np.asarray(o["waypoint"], np.float32)[:2]
                                for o in observations])

        prog = engine.prog
        outputs = envs.step([
            {"action": actions[e],
             "prog": float(prog[e, 0]) if count_step >= 24 else -1,
             "epidsode_reset_flag": count_step == 0,
             "depth_img": observations[e]["depth"]}
            for e in range(len(observations))])
        observations, _, dones, infos = (list(x) for x in zip(*outputs))
        count_step += 1
        masks = np.array([[0.0] if d else [1.0] for d in dones], np.float32)

        observer.stepped(observations, infos, episodes)
        for i, episode in enumerate(episodes):
            if dones[i]:
                stats_episodes[episode.episode_id] = infos[i]
                observer.episode_done(i, episode, infos[i])
