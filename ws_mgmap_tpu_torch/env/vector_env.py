"""Vectorized environments: worker processes with pause/resume.

Re-provides habitat `VectorEnv` as used by the reference
(`common/env_utils.py:73-77`, pause/resume in `common_trainer.py:141-187`):
N simulator workers behind pipes, stepped in lockstep, individually pausable
when their episodes finish. A synchronous in-process mode (``workers=False``)
backs unit tests and debugging.

The port's copy of ``ws_mgmap_tpu/env/vector_env.py``. Workers start from
a forkserver, never by ``fork``: the parent may hold a CUDA context, and
nothing a worker imports touches ``torch.cuda``. Each worker's env sees
``ENV_WORKER`` set to its share of the host's cores, the torch thread
count its CPU DD-PPO controller takes. A ``SIMULATOR.TYPE`` other than
FakeSim builds ``env/habitat_backend.py``'s adapter in each env; where
habitat-sim is not installed, ``construct_envs`` raises ``ImportError``.
"""
from __future__ import annotations

import multiprocessing as mp
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

STEP, RESET, CLOSE, CALL, EPISODE, COUNT_EPISODES = (
    "step", "reset", "close", "call", "episode", "count_episodes")

# set in each worker process: the torch threads its env may use
ENV_WORKER = "WS_MGMAP_ENV_WORKER"


def worker_threads(num_workers: int) -> int:
    """Each worker's share of the host's cores, one left to the parent."""
    return max(1, (os.cpu_count() or 1) // (num_workers + 1))


def _worker(pipe, env_fn, env_args, threads: int):
    os.environ[ENV_WORKER] = str(threads)
    env = env_fn(*env_args)
    try:
        while True:
            cmd, data = pipe.recv()
            if cmd == STEP:
                pipe.send(env.step(data))
            elif cmd == RESET:
                pipe.send(env.reset())
            elif cmd == EPISODE:
                pipe.send(env.current_episode())
            elif cmd == COUNT_EPISODES:
                pipe.send(env.number_of_episodes())
            elif cmd == CALL:
                name, kwargs = data
                pipe.send(getattr(env, name)(**(kwargs or {})))
            elif cmd == CLOSE:
                pipe.send(True)
                break
    except (KeyboardInterrupt, EOFError):
        pass


class VectorEnv:
    def __init__(self, env_fns: List[Tuple[Callable, tuple]],
                 workers: bool = True):
        self._workers_mode = workers
        self._paused: List[Tuple[int, Any]] = []
        if workers:
            # fork would copy the parent's CUDA context and its threads;
            # forkserver keeps workers clean like habitat's spawn use.
            ctx = mp.get_context("forkserver")
            threads = worker_threads(len(env_fns))
            self._pipes = []
            self._procs = []
            for fn, args in env_fns:
                parent, child = ctx.Pipe()
                proc = ctx.Process(target=_worker,
                                   args=(child, fn, args, threads),
                                   daemon=True)
                proc.start()
                child.close()
                self._pipes.append(parent)
                self._procs.append(proc)
            self._conns = list(self._pipes)
        else:
            self._envs = [fn(*args) for fn, args in env_fns]
            self._conns = list(range(len(self._envs)))

    # -- plumbing -----------------------------------------------------------
    def _send(self, conn, cmd, data=None):
        if self._workers_mode:
            conn.send((cmd, data))
        else:
            env = self._envs[conn]
            if cmd == STEP:
                self._sync_result = env.step(data)
            elif cmd == RESET:
                self._sync_result = env.reset()
            elif cmd == EPISODE:
                self._sync_result = env.current_episode()
            elif cmd == COUNT_EPISODES:
                self._sync_result = env.number_of_episodes()
            elif cmd == CALL:
                name, kwargs = data
                self._sync_result = getattr(env, name)(**(kwargs or {}))
            elif cmd == CLOSE:
                self._sync_result = True

    def _recv(self, conn):
        return conn.recv() if self._workers_mode else self._sync_result

    # -- public surface (habitat VectorEnv-compatible) ----------------------
    @property
    def num_envs(self) -> int:
        return len(self._conns)

    def reset(self) -> List[Dict[str, Any]]:
        out = []
        for c in self._conns:
            self._send(c, RESET)
            out.append(self._recv(c))
        return out

    def step(self, inputs: List[Dict[str, Any]]):
        assert len(inputs) == self.num_envs
        if self._workers_mode:
            for c, inp in zip(self._conns, inputs):
                self._send(c, STEP, inp)
            return [self._recv(c) for c in self._conns]
        out = []
        for c, inp in zip(self._conns, inputs):
            self._send(c, STEP, inp)
            out.append(self._recv(c))
        return out

    def current_episodes(self) -> List[Any]:
        out = []
        for c in self._conns:
            self._send(c, EPISODE)
            out.append(self._recv(c))
        return out

    @property
    def number_of_episodes(self) -> List[int]:
        out = []
        for c in self._conns:
            self._send(c, COUNT_EPISODES)
            out.append(self._recv(c))
        return out

    def call(self, name: str, kwargs_list: Optional[List[dict]] = None):
        kwargs_list = kwargs_list or [None] * self.num_envs
        if self._workers_mode:
            for c, kw in zip(self._conns, kwargs_list):
                self._send(c, CALL, (name, kw))
            return [self._recv(c) for c in self._conns]
        # in process each result must be read before the next call (the
        # JAX package's copy returns the last env's result for every env)
        out = []
        for c, kw in zip(self._conns, kwargs_list):
            self._send(c, CALL, (name, kw))
            out.append(self._recv(c))
        return out

    def pause_at(self, index: int) -> None:
        """`common_trainer.py:155-161`."""
        self._paused.append((index, self._conns.pop(index)))

    def resume_all(self) -> None:
        for index, conn in reversed(sorted(self._paused, key=lambda x: x[0])):
            self._conns.insert(index, conn)
        self._paused = []

    def close(self) -> None:
        for c in list(self._conns) + [c for _, c in self._paused]:
            try:
                self._send(c, CLOSE)
                self._recv(c)
            except Exception:
                pass
        if self._workers_mode:
            for p in self._procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()


def construct_envs(
    config,
    dataset,
    gt_locations=None,
    auto_reset_done: bool = True,
    workers: bool = True,
    env_cls=None,
):
    """`construct_envs` (`common/env_utils.py:11-88`): round-robin scene
    assignment across NUM_PROCESSES workers."""
    from ws_mgmap_tpu_torch.env.dataset import round_robin_scene_split
    from ws_mgmap_tpu_torch.env.environments import VLNCEDaggerEnv

    env_cls = env_cls or VLNCEDaggerEnv
    n = config.NUM_PROCESSES
    scenes = dataset.scenes()
    if n > 1 and len(scenes) < n:
        # unlike the reference's hard error, degrade to episode-level split
        splits = [scenes for _ in range(n)]
    else:
        import random as _random
        scenes = list(scenes)
        if n > 1:
            _random.Random(0).shuffle(scenes)
        splits = round_robin_scene_split(scenes, n)

    env_fns = []
    for i in range(n):
        sub = dataset.filter_scenes(splits[i]) if len(scenes) >= n else dataset
        if len(sub.episodes) == 0:
            sub = dataset
        env_fns.append((
            env_cls,
            (config, sub, gt_locations, _default_sim_factory(config),
             None, auto_reset_done, i),
        ))
    return VectorEnv(env_fns, workers=workers)


def _default_sim_factory(config):
    import functools

    sim = config.TASK_CONFIG.SIMULATOR
    rgb_hw = (sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH)
    depth_hw = (sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH)
    if sim.TYPE == "FakeSim":
        from ws_mgmap_tpu_torch.env.sim import FakeSim
        return functools.partial(FakeSim, rgb_hw=rgb_hw, depth_hw=depth_hw)
    from ws_mgmap_tpu_torch.env import habitat_backend
    if not habitat_backend.HABITAT_AVAILABLE:
        # here, before any worker starts: an env builds its simulator only
        # at its first reset, in its worker
        raise ImportError(f"SIMULATOR.TYPE {sim.TYPE!r} needs habitat_sim, "
                          "which is not installed; use FakeSim or install "
                          "habitat-sim v0.1.5")
    # the full SIMULATOR node travels to the adapter so sensor specs (HFOV,
    # positions, depth normalization) and agent radius/height are config-
    # faithful (`vlnce_task.yaml:3-21`)
    return functools.partial(habitat_backend.HabitatSimBackend, sim_cfg=sim,
                             rgb_hw=rgb_hw, depth_hw=depth_hw)
