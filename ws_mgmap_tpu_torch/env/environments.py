"""VLN-CE episode environment over a SimBackend.

The port's copy of ``ws_mgmap_tpu/env/environments.py``; the DD-PPO
controller is the port's (``models/ddppo_policy.py``).

Re-provides `VLNCEDaggerEnv` (`vlnce_baselines/common/environments.py:15-87`)
plus the habitat `Env` episode/measure machinery it builds on: episode
iteration, sensor suite, measures, max-step termination, and the reference's
control protocol — forced 24-step look-around spin
(`environments.py:53-54`), progress-threshold stop (`decide_stop`,
`environments.py:66-71`), waypoint -> discrete action via the GT follower
(collection) or DD-PPO controller (eval).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ws_mgmap_tpu_torch.env.action_maker import DDPPOActionMaker, GTMapActionMaker
from ws_mgmap_tpu_torch.env.dataset import Episode, VLNCEDataset
from ws_mgmap_tpu_torch.env.measures import default_measures
from ws_mgmap_tpu_torch.env.sensors import (
    GtSemanticMapSensor,
    PathSensor,
    SemanticFilterSensor,
    SENSOR_REGISTRY,
    SensorContext,
    WaypointSensor,
)
from ws_mgmap_tpu_torch.env.sim import FakeSim, STOP


class EpisodeIterator:
    """Scene-grouped episode cycling (habitat EpisodeIterator-lite)."""

    def __init__(self, episodes: List[Episode], shuffle: bool = True,
                 seed: int = 0, cycle: bool = True):
        self.episodes = list(episodes)
        self.cycle = cycle
        self.rng = np.random.RandomState(seed)
        if shuffle:
            by_scene: Dict[str, List[Episode]] = {}
            for ep in self.episodes:
                by_scene.setdefault(ep.scene_id, []).append(ep)
            scenes = list(by_scene)
            self.rng.shuffle(scenes)
            order = []
            for s in scenes:
                eps = by_scene[s]
                self.rng.shuffle(eps)
                order.extend(eps)
            self.episodes = order
        self._idx = -1

    def next_episode(self) -> Optional[Episode]:
        self._idx += 1
        if self._idx >= len(self.episodes):
            if not self.cycle:
                return None
            self._idx = 0
        return self.episodes[self._idx]


class VLNCEDaggerEnv:
    """Single-process env. Step input mirrors the trainer's dict protocol
    (`dagger_trainer.py:471-477`, `common_trainer.py:341-349`):
    {'action': waypoint[2], 'prog': float, 'epidsode_reset_flag': bool,
    'depth_img': ...}.
    """

    LOOK_AROUND_STEPS = 24  # initial 360 spin (`environments.py:53-54`)

    def __init__(
        self,
        config,
        dataset: VLNCEDataset,
        gt_locations: Optional[Dict[str, Any]] = None,
        sim_factory=FakeSim,
        controller=None,
        auto_reset_done: bool = True,
        seed: int = 0,
    ):
        self.config = config
        task_cfg = config.TASK_CONFIG
        self.dataset = dataset
        self.gt_locations = gt_locations or {}
        self.max_episode_steps = task_cfg.ENVIRONMENT.MAX_EPISODE_STEPS
        self.success_distance = task_cfg.TASK.SUCCESS_DISTANCE
        self.prog_threshold = config.STOP_CONDITION.PROG_THRESHOLD
        self.use_ddppo = config.use_ddppo
        self.auto_reset_done = auto_reset_done
        self.sim_factory = sim_factory

        self.iterator = EpisodeIterator(
            dataset.episodes,
            shuffle=task_cfg.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE,
            seed=seed,
        )
        self._sims: Dict[str, Any] = {}
        self.sensor_ctx = SensorContext(task_cfg)
        self.waypoint_sensor = WaypointSensor(task_cfg.TASK.VLN_ORACLE_WAYPOINT_SENSOR)
        self.waypoint_sensor.set_gt_locations(self.gt_locations)
        self.path_sensor = PathSensor(task_cfg.TASK.VLN_ORACLE_PATH_SENSOR)
        self.gt_semmap_sensor = GtSemanticMapSensor(task_cfg.TASK.GT_SEMANTIC_MAP_SENSOR)
        self.semantic_filter_sensor = SemanticFilterSensor(
            task_cfg.TASK.SEMANTIC_FILTER_SENSOR)
        self.enabled_sensors = list(task_cfg.TASK.SENSORS)

        ego = config.ego_map_size
        if self.use_ddppo:
            if controller is None:
                controller = self._build_controller(config)
            self.action_maker = DDPPOActionMaker(ego, controller=controller)
        else:
            self.action_maker = GTMapActionMaker(ego)

        self.measures = default_measures(self.gt_locations, self.success_distance)
        self.sim = None
        self.episode: Optional[Episode] = None
        self._elapsed_steps = 0
        self.episode_over = False
        self._stop_called = False

    @staticmethod
    def _build_controller(config):
        """Lazy DD-PPO local-controller construction. Inside an env worker
        it runs on the CPU with the worker's share of the host's threads
        (``vector_env.ENV_WORKER``), so workers never touch the card; in
        process it runs on the card."""
        import os

        import torch

        from ws_mgmap_tpu_torch.env.vector_env import ENV_WORKER
        from ws_mgmap_tpu_torch.models.ddppo_policy import DdppoController

        device = None
        threads = os.environ.get(ENV_WORKER)
        if threads:
            device = "cpu"
            torch.set_num_threads(int(threads))
        path = getattr(config, "DDPPO_CONTROLLER_CKPT", "")
        if path and os.path.exists(path):
            return DdppoController.from_torch_checkpoint(path, device=device)
        print("[env] DD-PPO controller ckpt missing; using random init")
        return DdppoController(device=device)

    # -- core API ----------------------------------------------------------
    def current_episode(self) -> Episode:
        return self.episode

    def number_of_episodes(self) -> int:
        return len(self.dataset.episodes)

    def reset(self) -> Dict[str, Any]:
        self.episode = self.iterator.next_episode()
        ep = self.episode
        if ep.scene_id not in self._sims:
            self._sims[ep.scene_id] = self.sim_factory(ep.scene_id)
        self.sim = self._sims[ep.scene_id]
        self.sim.reset_agent(ep.start_position, ep.start_rotation_quat)
        if hasattr(self.sim, "set_goal"):  # FakeSim goal beacon (testbed)
            self.sim.set_goal(ep.goals[0]["position"])
        if not ep.info.get("geodesic_distance"):
            ep.info["geodesic_distance"] = self.sim.geodesic_distance(
                np.asarray(ep.start_position), ep.goals[0]["position"])
        self._elapsed_steps = 0
        self.episode_over = False
        self._stop_called = False
        self.sensor_ctx.on_episode_start(self.sim, ep)
        for m in self.measures:
            m.reset_metric(self.sim, ep)
        if self.use_ddppo:
            self.action_maker.reset()
        return self._observations()

    def _observations(self) -> Dict[str, Any]:
        obs = self.sim.render()
        raw_semantic = obs.pop("semantic", None)
        ctx = self.sensor_ctx
        # heading first: it feeds record_heading for the GT map sensor
        obs["heading"] = SENSOR_REGISTRY["heading"](self.sim, self.episode, ctx)
        for uuid in ("gps", "compass", "progress", "instruction",
                     "vln_oracle_action_sensor"):
            obs[uuid] = SENSOR_REGISTRY[uuid](self.sim, self.episode, ctx)
        obs["waypoint"] = self.waypoint_sensor(self.sim, self.episode, ctx)
        if "VLN_ORACLE_PATH_SENSOR" in self.enabled_sensors:
            obs["gt_path"] = self.path_sensor(self.sim, self.episode, ctx)
        if "GT_SEMANTIC_MAP_SENSOR" in self.enabled_sensors:
            obs["gt_semantic_map"] = self.gt_semmap_sensor(
                self.sim, self.episode, ctx)
        if ("SEMANTIC_FILTER_SENSOR" in self.enabled_sensors
                and raw_semantic is not None):
            # eval-video overlay: instance->mpcat40->27 one-hot
            # (`sensors.py:318-359`; enabled by the trainer's video-eval
            # config surgery like `common_trainer.py:275`)
            obs["semantic_filter"] = self.semantic_filter_sensor(
                self.sim, self.episode, ctx, semantic=raw_semantic)
        return obs

    def decide_stop(self, prog: float) -> bool:
        """`environments.py:66-71`."""
        if prog == -1 and self.sim.geodesic_distance(
                self.sim.get_agent_state().position,
                self.episode.goals[0]["position"]) < 0.5:
            return True
        return prog > self.prog_threshold

    def step(self, step_input: Dict[str, Any]):
        action = np.asarray(step_input["action"], np.float64).reshape(-1)
        prog = float(step_input.get("prog", -1))
        if self.use_ddppo and step_input.get("epidsode_reset_flag"):
            self.action_maker.reset()
            self._ddppo_t = 0

        agent_state = self.sim.get_agent_state()
        waypoint_w = self.action_maker.preprocess(action, agent_state)
        if self.use_ddppo:
            action_choice = self.action_maker.action_decision(
                self.sim, waypoint_w, step_input.get("depth_img"),
                getattr(self, "_ddppo_t", 0))
            self._ddppo_t = getattr(self, "_ddppo_t", 0) + 1
        else:
            action_choice = self.action_maker.action_decision(self.sim, waypoint_w)

        if self.decide_stop(prog):
            action_choice = STOP
        if self._elapsed_steps < self.LOOK_AROUND_STEPS:
            action_choice = 2  # TURN_LEFT spin (`environments.py:53-54`)

        self._stop_called = action_choice == STOP
        if action_choice != STOP:
            self.sim.step(action_choice)
        self._elapsed_steps += 1
        self.episode_over = (
            self._stop_called or self._elapsed_steps >= self.max_episode_steps
        )

        for m in self.measures:
            m.update_metric(self.sim, self.episode, action_choice,
                            self._stop_called)

        done = self.episode_over
        info = self.get_metrics()
        if done and self.auto_reset_done:
            obs = self.reset()
        else:
            obs = self._observations()
        return obs, 0.0, done, info

    def get_metrics(self) -> Dict[str, float]:
        return {m.uuid: m.get_metric() for m in self.measures}


class VLNCEInferenceEnv(VLNCEDaggerEnv):
    """`environments.py:90-114`: leaderboard info instead of metrics."""

    def get_metrics(self) -> Dict[str, Any]:
        ag = self.sim.get_agent_state()
        from ws_mgmap_tpu_torch.utils.geometry import heading_from_quaternion, quat_inverse
        return {
            "position": ag.position.tolist(),
            "heading": heading_from_quaternion(quat_inverse(ag.rotation)),
            "stop": self._stop_called,
        }
