"""DAgger rollout collection into the trajectory store.

Port of ``ws_mgmap_tpu/train/collector.py``, which re-provides
`DaggerTrainer._update_dataset` (`dagger_trainer.py:249-503`): beta-mixed
policy/oracle rollouts with feature caching, episode subsampling and store
top-up. The engine is the port's ``RolloutEngine``: ``act`` returns the
cached features (UNet bottleneck, depth trunk, ego map) as card tensors,
which come to the host in fp16, channels-last, as the JAX package stores
them, so either package's loader reads the other's store. Each rank
appends to its own store shard.
"""
from __future__ import annotations

import os
from typing import List, Optional, Set

import numpy as np
import torch

from ws_mgmap_tpu_torch.data.trajstore import TrajStoreReader, TrajStoreWriter
from ws_mgmap_tpu_torch.env.vector_env import construct_envs
from ws_mgmap_tpu_torch.train.replay import episode_to_record
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine
from ws_mgmap_tpu_torch.utils.profiling import StepTimers

# flush pending records early when the host has less than this available
# (`dagger_trainer.py:394-398`)
LOW_RAM_BYTES = 10 * 1024 ** 3


def mem_available_bytes() -> int:
    """The system's ``MemAvailable`` (``/proc/meminfo``): the memory that
    can be allocated without swapping, what ``psutil.virtual_memory()
    .available`` reports on Linux."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def to_host_fp16(t: torch.Tensor) -> np.ndarray:
    """A card tensor as a host fp16 array (rounded to nearest even, as
    numpy's cast of the fp32 value rounds)."""
    return t.to(torch.float16).cpu().numpy()


def collect_dataset(
    config,
    engine: RolloutEngine,
    dataset,
    gt_locations,
    store_dir: str,
    data_it: int,
    rank: int = 0,
    world_size: int = 1,
    workers: bool = True,
    rng: Optional[np.random.RandomState] = None,
    log_fn=print,
    timers: Optional[StepTimers] = None,
) -> int:
    """Top up the store to (data_it+1) * UPDATE_SIZE episodes; returns the
    number of episodes this rank appended."""
    rng = rng or np.random.RandomState(1000 + rank)
    os.makedirs(store_dir, exist_ok=True)
    if timers is None:
        timers = StepTimers()

    # DAgger beta schedule (`dagger_trainer.py:291-299`)
    p = config.DAGGER.P
    beta = 0.0 if p == 0.0 else p ** data_it
    ensure_unique = beta == 1.0

    shard_ds = dataset.split_by_rank(world_size, rank) if world_size > 1 else dataset
    envs = construct_envs(config, shard_ds, gt_locations,
                          auto_reset_done=True, workers=workers)
    n = envs.num_envs
    engine.reset_state(n)

    writer = TrajStoreWriter(store_dir, rank=rank, threads=8)
    required = (data_it + 1) * config.DAGGER.UPDATE_SIZE

    observations = envs.reset()
    batch = engine.batch_obs(observations)
    masks = np.zeros((n, 1), np.float32)
    episodes: List[list] = [[] for _ in range(n)]
    step_counts = [0] * n
    dones = [False] * n
    prev_actions = np.zeros((n, 2), np.float32)
    cache = {"rgb": [None] * n, "depth": [None] * n, "ego": [None] * n}
    # Unique-episode (beta=1) dedup: each slot's episode id is pinned at
    # episode START and its record matched to that id at flush (the
    # reference reads the id after habitat's auto-reset, i.e. the
    # successor's, `dagger_trainer.py:361-362,400-406`); `ep_ids_started`
    # keeps the reference's early pause (stop a slot as soon as its
    # iterator wraps to an episode any slot already started).
    ep_ids_collected: Set[str] = set()  # flushed to the store + logged
    ep_ids_started: Set[str] = set()    # rollout begun (reference set)
    slot_ep_ids: List[Optional[str]] = [None] * n
    if ensure_unique:
        slot_ep_ids = [e.episode_id for e in envs.current_episodes()]
        ep_ids_started |= set(slot_ep_ids)

    count_step = 0
    collected = 0
    mix_taken = 0  # oracle-waypoint steps actually taken (beta diagnostics)
    mix_total = 0
    pending_records: List[bytes] = []

    def store_count() -> int:
        r = TrajStoreReader(store_dir)
        c = len(r)
        r.close()
        return c

    current_total = store_count()
    while current_total + len(pending_records) < required:
        current_episodes = envs.current_episodes() if ensure_unique else None
        envs_to_pause: List[int] = []

        # flush finished episodes (`dagger_trainer.py:363-409`)
        for i in range(envs.num_envs):
            if dones[i]:
                eid = slot_ep_ids[i] if ensure_unique else None
                dup = ensure_unique and eid in ep_ids_collected
                rec = None if dup else episode_to_record(
                    episodes[i], spin_steps=24, step_num=config.step_num,
                    min_len=25, max_len=config.ep_max_len, ep_id=eid)
                if rec is not None:
                    pending_records.append(rec)
                    collected += 1
                    if ensure_unique:
                        ep_ids_collected.add(eid)
                        # dedup log (`dagger_trainer.py:400-406`), with the
                        # FINISHED episode's id
                        with open(os.path.join(
                                store_dir, "collected_ep.txt"), "a") as fp:
                            fp.write(f"{eid}\n")
                if ensure_unique:
                    # env already auto-reset: adopt the successor episode,
                    # pausing the slot if any slot already started it
                    new_eid = current_episodes[i].episode_id
                    if new_eid in ep_ids_started:
                        envs_to_pause.append(i)
                    else:
                        ep_ids_started.add(new_eid)
                        slot_ep_ids[i] = new_eid
                episodes[i] = []
                step_counts[i] = 0
                dones[i] = False

        low_ram = mem_available_bytes() < LOW_RAM_BYTES
        if pending_records and (
                len(pending_records) >= config.DAGGER.LMDB_COMMIT_FREQUENCY
                or low_ram):  # RAM watermark flush (`dagger_trainer.py:394-398`)
            writer.append_batch(pending_records)
            writer.flush()
            current_total = store_count()
            pending_records = []

        if envs_to_pause:
            keep = [i for i in range(envs.num_envs) if i not in envs_to_pause]
            for i in reversed(envs_to_pause):
                envs.pause_at(i)
                episodes.pop(i)
                step_counts.pop(i)
                dones.pop(i)
                slot_ep_ids.pop(i)
            if not keep:
                break  # every env exhausted its unique episodes
            engine.keep(keep)
            prev_actions = prev_actions[keep]
            masks = masks[keep]
            observations = [observations[i] for i in keep]
            batch = engine.batch_obs(observations)
            for k in cache:
                cache[k] = [cache[k][i] for i in keep]

        # policy/map step (`dagger_trainer.py:430-445`); each span ends in
        # the copy to the host, so it holds the card's work
        if count_step % config.step_num == 0:
            with timers.span("collect/act"):
                out = engine.act(batch, masks)
                actions = out.action.cpu().numpy()
                cache["rgb"] = to_host_fp16(out.rgb_features)
                cache["depth"] = to_host_fp16(out.depth_features)
                cache["ego"] = to_host_fp16(out.ego_map)
        else:
            with timers.span("collect/update_map"):
                ego = engine.update_map(batch, masks)
                cache["ego"] = to_host_fp16(ego)
            actions = prev_actions.copy()
        count_step += 1

        for i in range(envs.num_envs):
            step_counts[i] += 1
            if step_counts[i] == 23:
                engine.zero_hidden_at(i)

        # beta mixing (`dagger_trainer.py:447-449`)
        waypoints = np.stack([np.asarray(o["waypoint"], np.float32)
                              for o in observations])
        mix = rng.rand(envs.num_envs) < beta
        actions = np.where(mix[:, None], waypoints, actions)
        mix_taken += int(mix.sum())
        mix_total += envs.num_envs

        # append step with cached features (`dagger_trainer.py:451-469`)
        for i in range(envs.num_envs):
            obs_i = dict(observations[i])
            obs_i.pop("rgb", None)
            obs_i.pop("depth", None)
            obs_i["instruction"] = np.asarray(
                obs_i["instruction"]["tokens"]
                if isinstance(obs_i["instruction"], dict)
                else obs_i["instruction"], np.int64)
            obs_i["rgb_features"] = cache["rgb"][i]
            obs_i["depth_features"] = cache["depth"][i]
            obs_i["rgb_ego_map"] = cache["ego"][i]
            episodes[i].append((obs_i, prev_actions[i].copy(),
                                waypoints[i].copy()))

        step_inputs = [{"action": actions[i], "prog": -1}
                       for i in range(envs.num_envs)]
        with timers.span("collect/env_step"):
            outputs = envs.step(step_inputs)
        observations = [o[0] for o in outputs]
        dones = [o[2] for o in outputs]
        masks = np.array([[0.0] if d else [1.0] for d in dones], np.float32)
        prev_actions = actions
        with timers.span("collect/batch_obs"):
            batch = engine.batch_obs(observations)

    if pending_records:
        writer.append_batch(pending_records)
    writer.flush()
    writer.close()
    envs.close()
    log_fn(f"[collect] rank {rank}: appended {collected} episodes "
           f"(store total {store_count()}); beta={beta:.3f} "
           f"oracle-mix {mix_taken}/{mix_total}"
           f" ({mix_taken / max(mix_total, 1):.2f})")
    timers.report(log_fn)
    return collected
