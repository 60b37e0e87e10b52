"""Replay pipeline: episode records -> episode-major training batches.

The port's copy of ``ws_mgmap_tpu/train/replay.py`` (plain numpy) on the
port's trajectory store (``data/trajstore.py``):
  * writer side: the temporal subsample ``steps[24::3]`` after the
    look-around spin, the 25..200-step length filter and dtype narrowing
    (:func:`episode_to_record`);
  * reader side (:class:`ReplayLoader`): contiguous rank index ranges, a
    block shuffle seeded per epoch, length-sorted batches, a background
    thread that builds batches ahead of the consumer, fanning each
    batch's record reads and episode rows out over a pool of worker
    threads (:func:`loader_threads`);
  * collate (:func:`collate_episodes`): episode-major [N, T, ...] padded
    with 1.0, zero weights on padding, not-done masks 0 at t=0.
On the same store, seed, rank and world size the loader yields the JAX
package's batches bit for bit.
"""
from __future__ import annotations

import glob
import os
import queue
import random
import threading
from concurrent.futures import Executor, ThreadPoolExecutor
from typing import Any, Iterator, Sequence

import numpy as np
import torch.distributed as dist

from ws_mgmap_tpu_torch.data.trajstore import (TrajStoreReader, pack_record,
                                               unpack_record)
from ws_mgmap_tpu_torch.utils import profiling

NARROW_DTYPES = {
    "vln_oracle_action_sensor": np.uint8,
    "rgb_ego_map": np.float16,
    "gt_path": np.float16,
    "rgb": np.uint8,
    "depth": np.float16,
    "rgb_features": np.float16,
    "depth_features": np.float16,
    "gt_semantic_map": np.int32,
}

# observations a stored episode does not keep
EPISODE_OBS_DROP = ("heading", "compass", "gps")


def narrow_obs(obs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Each observation in its stored dtype (:data:`NARROW_DTYPES`)."""
    out = {}
    for k, v in obs.items():
        v = np.asarray(v)
        out[k] = v.astype(NARROW_DTYPES[k]) if k in NARROW_DTYPES else v
    return out


def episode_to_record(
    steps: list[tuple[dict[str, np.ndarray], np.ndarray, np.ndarray]],
    spin_steps: int = 24,
    step_num: int = 3,
    min_len: int = 25,
    max_len: int = 200,
    ep_id: str | None = None,
) -> bytes | None:
    """(obs, prev_action, oracle_waypoint) per simulator step -> a packed
    record of ``steps[spin_steps::step_num]``, or None when the episode
    has more than ``max_len`` or fewer than ``min_len`` steps. ``ep_id``
    (collection with unique-episode dedup) is stored in the record."""
    if len(steps) > max_len or len(steps) < min_len:
        return None
    sub = steps[spin_steps::step_num]
    if not sub:
        return None
    obs_keys = [k for k in sub[0][0] if k not in EPISODE_OBS_DROP]
    obs = {k: np.stack([np.asarray(s[0][k]) for s in sub]) for k in obs_keys}
    record = {
        "obs": narrow_obs(obs),
        "prev_actions": np.stack([s[1] for s in sub]).astype(np.float32),
        "oracle_actions": np.stack([s[2] for s in sub]).astype(np.float32),
    }
    if ep_id is not None:
        record["ep_id"] = str(ep_id)
    return pack_record(record)


def _block_shuffle(items: list[int], block_size: int,
                   rng: random.Random) -> list[int]:
    """``items`` cut into blocks of ``block_size``, the blocks shuffled."""
    blocks = [items[i:i + block_size] for i in range(0, len(items), block_size)]
    rng.shuffle(blocks)
    return [x for b in blocks for x in b]


def loader_threads(batch_size: int) -> int:
    """The loader's worker threads: one an episode of a batch, at most
    this process's share of the cores it may run on (its CPU affinity,
    split among the ranks torchrun started on this host when a process
    group is up)."""
    ranks = 1
    if dist.is_available() and dist.is_initialized():
        ranks = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    cores = len(os.sched_getaffinity(0))
    return max(1, min(batch_size, cores // ranks))


class ReplayLoader:
    """Iterates collated batches over a trajectory store directory.

    Rank ``rank`` of ``world_size`` reads records [per * rank, per * (rank
    + 1)) with per = len // world_size; each epoch (each ``iter``)
    block-shuffles them with ``random.Random(seed + epoch)`` into batches
    of ``batch_size`` episodes, sorted by length within the batch. Every
    rank must hand the update batches of one shape when world_size > 1:
    ``fixed_len`` pads each to ``max_len`` steps.

    A batch's records are read and inflated, and its episodes' rows
    filled, on a pool of :func:`loader_threads` worker threads, created
    on the first iteration; the batches are the same as one thread's.
    """

    def __init__(
        self,
        directory: str,
        batch_size: int,
        rank: int = 0,
        world_size: int = 1,
        max_len: int = 200,
        seed: int = 0,
        drop_last: bool = True,
        fixed_len: bool = False,
    ):
        self.reader = TrajStoreReader(directory)
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        self.max_len = max_len
        self.fixed_len = fixed_len
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        self._pool: Executor | None = None

    def __len__(self) -> int:
        per = len(self.reader) // self.world_size
        return per // self.batch_size if self.drop_last else -(-per // self.batch_size)

    def _drop_page_cache(self):
        """Advise the kernel to drop the store's cached pages before an
        epoch (``posix_fadvise`` DONTNEED), as the reference does."""
        for shard in glob.glob(os.path.join(self.reader.directory,
                                            "shard_*.bin")):
            try:
                fd = os.open(shard, os.O_RDONLY)
                try:
                    os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                finally:
                    os.close(fd)
            except OSError:
                pass

    def _fetch(self, i: int) -> dict[str, Any]:
        """Record ``i``, read, inflated and unpacked (a worker's task)."""
        with profiling.span("replay.fetch"):
            return unpack_record(self.reader.get(i))

    def _batches(self, pool: Executor) -> Iterator[dict[str, Any]]:
        rng = random.Random(self.seed + self._epoch)
        self._epoch += 1
        self._drop_page_cache()
        per = len(self.reader) // self.world_size
        start = per * self.rank
        order = _block_shuffle(list(range(start, start + per)),
                               self.batch_size, rng)
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            with profiling.span("replay.read"):
                eps = list(pool.map(self._fetch, chunk))
            eps.sort(key=lambda e: e["prev_actions"].shape[0])
            with profiling.span("replay.collate"):
                batch = collate_episodes(eps, self.max_len,
                                         fixed_len=self.fixed_len, pool=pool)
            yield batch

    def __iter__(self) -> Iterator[dict[str, Any]]:
        """One epoch; a background thread builds up to two batches ahead
        of the consumer. An error in building a batch is raised here, in
        the consumer, after the batches before it."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(loader_threads(self.batch_size),
                                            thread_name_prefix="replay")
        pool = self._pool
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()
        stop = threading.Event()

        def producer():
            try:
                for b in self._batches(pool):
                    q.put(b)
                    if stop.is_set():
                        break
            except Exception as e:  # any error: the consumer raises it
                q.put(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, name="replay-producer",
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that leaves early: the producer puts at most two
            # more items into the emptied queue and ends
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        t.join()


def collate_episodes(episodes: Sequence[dict[str, Any]],
                     max_len: int = 200,
                     t_bucket: int = 16,
                     fixed_len: bool = False,
                     pool: Executor | None = None) -> dict[str, Any]:
    """Pad and stack episodes to [N, T, ...].

    Each episode is {"obs": {key: [len, ...]}, "prev_actions": [len, 2],
    ...}. T is the longest episode rounded up to a multiple of
    ``t_bucket`` and capped at ``max_len`` (``max_len`` itself with
    ``fixed_len``). Observations are padded with 1.0, as the reference
    does (padded frames carry instructions of token 1 at every position),
    and float16 ones come back as float32. Returns {"obs": {...},
    "prev_actions": [N, T, 2], "weights": [N, T] (0 on padding),
    "not_done_masks": [N, T] (0 at t=0)}, every array writable.

    Each output is allocated once; each episode's rows are written in
    one pass, on ``pool``'s threads when one is given (numpy's copies
    release the interpreter lock), else in turn on this one.
    """
    n = len(episodes)
    if fixed_len:
        t_max = max_len
    else:
        t_max = min(max(e["prev_actions"].shape[0] for e in episodes), max_len)
        if t_bucket > 1:
            t_max = min(-(-t_max // t_bucket) * t_bucket, max_len)

    def empty(leaves, widen: bool) -> np.ndarray:
        dtype = np.result_type(*(leaf.dtype for leaf in leaves))
        if widen and dtype == np.float16:
            dtype = np.dtype(np.float32)
        return np.empty((n, t_max) + leaves[0].shape[1:], dtype)

    leaves = {k: [np.asarray(e["obs"][k]) for e in episodes]
              for k in episodes[0]["obs"]}
    obs = {k: empty(v, True) for k, v in leaves.items()}
    prev = [np.asarray(e["prev_actions"]) for e in episodes]
    prev_actions = empty(prev, False)

    def fill(i: int) -> None:
        with profiling.span("replay.fill"):
            for k, out in obs.items():
                _fill_row(out[i], leaves[k][i], 1.0)
            _fill_row(prev_actions[i], prev[i], 0.0)

    # list() reads every row's result: a worker's error is raised here
    list(pool.map(fill, range(n)) if pool is not None else map(fill, range(n)))
    weights = np.zeros((n, t_max), np.float32)
    for i, e in enumerate(episodes):
        weights[i, :min(e["prev_actions"].shape[0], t_max)] = 1.0
    masks = np.ones((n, t_max), np.float32)
    masks[:, 0] = 0.0
    return {
        "obs": obs,
        "prev_actions": prev_actions,
        "weights": weights,
        "not_done_masks": masks,
    }


def _fill_row(row: np.ndarray, steps: np.ndarray, pad: float) -> None:
    """``row`` [T, ...] <- the first ``min(len, T)`` of ``steps``, cast to
    ``row``'s dtype, then ``pad`` over the rest."""
    if steps.shape[1:] != row.shape[1:]:
        raise ValueError(f"episode steps of shape {steps.shape[1:]} in a "
                         f"batch of {row.shape[1:]}")
    k = min(steps.shape[0], row.shape[0])
    row[:k] = steps[:k]
    row[k:] = pad
