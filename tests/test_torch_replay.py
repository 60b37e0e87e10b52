"""The port's replay pipeline against the JAX package's: the records the
writer side packs, the batches ``ReplayLoader`` yields for every rank of
1, 2 and 3, and ``collate_episodes`` on a pool of any width, bit for bit;
the loader's collation reached through the module, its errors raised to
the consumer, the width of its pool, and the reuse of its host slabs."""
import os
import shutil
import struct
import sys
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests.torch_port_common import train_episodes
from ws_mgmap_tpu.train import replay as jreplay
from ws_mgmap_tpu_torch.data import trajstore
from ws_mgmap_tpu_torch.data.trajstore import (TrajStoreWriter, pack_record,
                                               unpack_record)
from ws_mgmap_tpu_torch.train import host_slabs, replay

LENGTHS = (5, 3, 9, 4, 7, 2, 6, 8, 3, 5, 10)


def sim_steps(rng, n):
    """``n`` simulator steps of (obs, prev_action, oracle waypoint), with
    every key the writer narrows or drops."""
    return [({
        "rgb": rng.randint(0, 255, (8, 8, 3)).astype(np.float32),
        "depth": rng.rand(8, 8, 1).astype(np.float32),
        "instruction": rng.randint(0, 50, 12).astype(np.int32),
        "rgb_features": rng.randn(2, 2, 4).astype(np.float32),
        "depth_features": rng.randn(2, 2, 3).astype(np.float32),
        "rgb_ego_map": rng.rand(4, 4, 8).astype(np.float32),
        "gt_path": rng.rand(4, 4).astype(np.float32) * 9,
        "gt_semantic_map": rng.randint(0, 27, (4, 4)).astype(np.int64),
        "vln_oracle_action_sensor": np.array([rng.randint(0, 4)]),
        "progress": np.array([rng.rand()], np.float32),
        "heading": np.array([rng.rand()], np.float32),
        "compass": np.array([rng.rand()], np.float32),
        "gps": rng.rand(2).astype(np.float32),
    }, rng.randn(2).astype(np.float64), rng.randn(2).astype(np.float64))
        for _ in range(n)]


def test_narrow_obs_matches_jax():
    obs = sim_steps(np.random.RandomState(0), 1)[0][0]
    got, want = replay.narrow_obs(obs), jreplay.narrow_obs(obs)
    assert replay.NARROW_DTYPES == jreplay.NARROW_DTYPES
    assert replay.EPISODE_OBS_DROP == jreplay.EPISODE_OBS_DROP
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("n_steps, ep_id", [(24, None), (25, None),
                                            (61, "ep-3"), (200, None),
                                            (201, None)])
def test_episode_to_record_matches_jax(n_steps, ep_id):
    """The [24::3] subsample, the 25..200-step filter, the dropped and
    narrowed observations: the same bytes, or None on both sides."""
    steps = sim_steps(np.random.RandomState(n_steps), n_steps)
    got = replay.episode_to_record(steps, ep_id=ep_id)
    assert got == jreplay.episode_to_record(steps, ep_id=ep_id)
    assert (got is None) == (not 25 <= n_steps <= 200)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """11 seeded small-width episodes in two writer ranks' shards."""
    d = tmp_path_factory.mktemp("replay") / "store"
    eps = train_episodes(np.random.RandomState(4), LENGTHS)
    for rank, part in ((0, eps[:6]), (1, eps[6:])):
        w = TrajStoreWriter(str(d), rank=rank)
        w.append_batch([pack_record(e) for e in part])
        w.close()
    return str(d)


def _assert_batches_equal(got, want, where):
    assert got.keys() == want.keys(), where
    for k in want:
        if isinstance(want[k], dict):
            _assert_batches_equal(got[k], want[k], f"{where} {k}")
        else:
            assert got[k].dtype == want[k].dtype, (where, k)
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{where} {k}")


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("fixed_len", [False, True])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_loader_matches_jax(store, world, fixed_len, drop_last):
    """Every rank's batches over two epochs: the same episodes, order,
    padding and dtypes as the JAX loader's."""
    kw = dict(batch_size=2, world_size=world, max_len=8, seed=5,
              fixed_len=fixed_len, drop_last=drop_last)
    seen = 0
    for rank in range(world):
        mine = replay.ReplayLoader(store, rank=rank, **kw)
        ref = jreplay.ReplayLoader(store, rank=rank, **kw)
        assert len(mine) == len(ref) > 0
        for epoch in range(2):
            got, want = list(mine), list(ref)
            assert len(got) == len(want) == len(ref), (rank, epoch)
            for i, (g, w) in enumerate(zip(got, want)):
                _assert_batches_equal(g, w, f"rank {rank} epoch {epoch} #{i}")
                if fixed_len:
                    assert g["weights"].shape[1] == 8
                seen += g["weights"].shape[0]
    per = len(LENGTHS) // world
    assert seen == 2 * world * (per - per % 2 if drop_last else per)


# every dtype the store keeps: (dtype, trailing shape)
LEAVES = {"u8": (np.uint8, (3,)), "i32": (np.int32, (2, 2)),
          "i64": (np.int64, ()), "f16": (np.float16, (4, 3)),
          "f32": (np.float32, (2,))}


def dtype_episodes(lengths) -> list[dict]:
    """Episodes with a leaf of each stored dtype, as the native reader
    hands them over: views of a writable inflated buffer."""
    rng = np.random.RandomState(11)
    eps = []
    for n in lengths:
        obs = {}
        for k, (dtype, shape) in LEAVES.items():
            if np.issubdtype(dtype, np.integer):
                obs[k] = rng.randint(0, 250, (n,) + shape).astype(dtype)
            else:
                obs[k] = (rng.randn(n, *shape) * 300).astype(dtype)
        ep = {"obs": obs, "prev_actions": rng.randn(n, 2).astype(np.float32),
              "oracle_actions": rng.randn(n, 2).astype(np.float32)}
        eps.append(unpack_record(np.frombuffer(pack_record(ep),
                                               np.uint8).copy()))
    return eps


@pytest.mark.parametrize("max_len", [8, 24])
@pytest.mark.parametrize("fixed_len", [False, True])
@pytest.mark.parametrize("width", [None, 1, 2, 9])
def test_collate_on_a_pool_matches_jax(width, fixed_len, max_len):
    """Five episodes of 1-12 steps (at ``max_len`` 8, two truncated; at
    24, padded to 16 or, with ``fixed_len``, to 24), in turn or on a pool narrower than, as wide as two of, and wider than
    the batch: the JAX collation's arrays, dtypes (float16 widened) and
    keys, every array writable."""
    eps = dtype_episodes((3, 12, 7, 1, 9))
    kw = dict(max_len=max_len, fixed_len=fixed_len)
    if width is None:
        got = replay.collate_episodes(eps, **kw)
    else:
        with ThreadPoolExecutor(width) as pool:
            got = replay.collate_episodes(eps, pool=pool, **kw)
    want = jreplay.collate_episodes(eps, **kw)
    _assert_batches_equal(got, want, f"width {width}")
    assert got["obs"]["f16"].dtype == np.float32
    assert got["weights"].shape[1] == (max_len if fixed_len
                                       else min(16, max_len))
    leaves = list(got["obs"].values()) + [got[k] for k in got if k != "obs"]
    assert all(a.flags.writeable for a in leaves)


def test_loader_collates_through_the_module(store, monkeypatch):
    """A patch of ``replay.collate_episodes`` reaches every batch the
    loader yields, and may write into the arrays it returns: what the
    benchmark's token fault relies on."""
    kw = dict(batch_size=2, max_len=8, seed=5)
    clean = list(replay.ReplayLoader(store, **kw))
    orig = replay.collate_episodes

    def collate(*a, **k):
        out = orig(*a, **k)
        tok = out["obs"]["instruction"]
        tok[0, :, 0] = tok[0, :, 0] % 2000 + 1
        return out

    monkeypatch.setattr(replay, "collate_episodes", collate)
    altered = list(replay.ReplayLoader(store, **kw))
    assert len(altered) == len(clean) == 5
    for got, want in zip(altered, clean):
        tok = want["obs"]["instruction"].copy()
        tok[0, :, 0] = tok[0, :, 0] % 2000 + 1
        np.testing.assert_array_equal(got["obs"]["instruction"], tok)
        assert not np.array_equal(tok, want["obs"]["instruction"])
        np.testing.assert_array_equal(got["weights"], want["weights"])


def _damage(directory: str, fault: str) -> None:
    """Shard 0's last record: its zlib header overwritten, or the shard
    cut short inside it."""
    with open(os.path.join(directory, "shard_0.idx"), "rb") as f:
        idx = f.read()
    off, csz, _ = struct.unpack_from("<QQQ", idx, len(idx) - 24)
    path = os.path.join(directory, "shard_0.bin")
    if fault == "corrupt":
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(b"\xff\xff")
    else:
        os.truncate(path, off + csz // 2)


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("fault", ["corrupt", "truncated"])
def test_loader_raises_a_bad_record(store, tmp_path, monkeypatch, fault,
                                    backend):
    """A record that cannot be read raises from the loader's iteration,
    within a minute: the epoch neither hangs nor ends short quietly."""
    d = str(tmp_path / "store")
    shutil.copytree(store, d)
    _damage(d, fault)
    if backend == "python":
        monkeypatch.setattr(trajstore, "_get_lib", lambda: None)
    loader = replay.ReplayLoader(d, batch_size=2, max_len=8, seed=5,
                                 drop_last=False)
    assert loader.reader.backend == backend
    got, raised = [], []

    def consume():
        try:
            for b in loader:
                got.append(b)
        except (OSError, zlib.error) as e:
            raised.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert len(raised) == 1, raised
    assert len(got) < len(loader) == 6


def test_collate_stress():
    """40 episodes on more threads than cores, switching threads every
    microsecond: the JAX collation's batch, bit for bit."""
    eps = dtype_episodes(np.random.RandomState(3).randint(1, 30, 40))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor((os.cpu_count() or 1) + 3) as pool:
            got = replay.collate_episodes(eps, max_len=24, pool=pool)
    finally:
        sys.setswitchinterval(old)
    _assert_batches_equal(got, jreplay.collate_episodes(eps, max_len=24),
                          "stress")


def test_consumer_that_leaves_early(store):
    """A consumer that closes its epoch after one batch lets the
    producer end, within a minute, and the next epoch runs whole."""
    loader = replay.ReplayLoader(store, batch_size=2, max_len=8, seed=5)
    it = iter(loader)
    next(it)
    it.close()
    for t in threading.enumerate():
        if t.name == "replay-producer":
            t.join(timeout=60)
            assert not t.is_alive()
    assert len(list(loader)) == len(loader) == 5


@pytest.mark.parametrize("batch_size", [1, 2, 8, 1000])
def test_loader_threads(monkeypatch, batch_size):
    """One worker an episode, at most the cores this process may use,
    shared among the ranks torchrun starts on a host once a process
    group is up."""
    cores = len(os.sched_getaffinity(0))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert replay.loader_threads(batch_size) == min(batch_size, cores)
    monkeypatch.setattr(replay.dist, "is_initialized", lambda: True)
    assert replay.loader_threads(batch_size) == max(
        1, min(batch_size, cores // 2))


@pytest.mark.parametrize("consumer", ["keeps", "drops"])
def test_loader_reuses_its_slabs(store, consumer):
    """Batches carved out of the loader's reusable slabs, over 3 epochs:
    a consumer that keeps every batch, and one that drops each at once,
    both see the JAX loader's batches, the kept ones intact after every
    later batch was built (a slab reused too early would overwrite
    them); the dropping one leaves the pool at queue depth + 2 slabs at
    most. Without CUDA no slab is page-locked."""
    kw = dict(batch_size=2, max_len=8, seed=5)
    mine = replay.ReplayLoader(store, **kw)
    ref = jreplay.ReplayLoader(store, **kw)
    kept = []
    for epoch in range(3):
        want = list(ref)
        got = 0
        for i, b in enumerate(mine):
            _assert_batches_equal(b, want[i], f"epoch {epoch} #{i}")
            if consumer == "keeps":
                kept.append((b, want[i]))
            got += 1
            del b
        assert got == len(want) == 5
    if consumer == "keeps":
        for i, (b, w) in enumerate(kept):
            _assert_batches_equal(b, w, f"kept #{i}")
        assert len(mine.slabs) == len(kept)
    else:
        assert 1 <= len(mine.slabs) <= 2 + 2
    if not torch.cuda.is_available():
        assert mine.pinned_slabs == mine.pinned_bytes == 0


def test_slab_pool_grows_to_the_largest_batch():
    """A slab is sized to the batch it is first needed for; a larger
    batch retires the smaller free slabs, and a smaller batch reuses a
    larger slab. Arrays are aligned, writable and disjoint."""
    pool = host_slabs.SlabPool()
    small = [((3, 5), np.dtype(np.float32)), ((7,), np.dtype(np.uint8))]
    large = [((30, 5), np.dtype(np.float32)), ((3, 2), np.dtype(np.int64))]
    a, b = pool.carve(small)
    assert a.shape == (3, 5) and b.shape == (7,) and len(pool) == 1
    assert all(x.flags.writeable and x.ctypes.data % host_slabs.ALIGN == 0
               for x in (a, b))
    a[:] = 1.0
    b[:] = 2
    assert (a == 1.0).all() and (b == 2).all()
    c = pool.carve(large)
    assert len(pool) == 2  # the small slab is still in use
    del a, b
    assert len(pool) == 1  # released while a larger batch exists: retired
    del c
    d = pool.carve(small)
    assert len(pool) == 1
    e = pool.carve(large)
    assert len(pool) == 2
    del d, e
    assert len(pool) == 2


def test_slab_pool_stress():
    """More threads than cores carve, fill, check and drop batches of one
    pool, switching threads every microsecond: no batch is overwritten
    while it is held (no slab is leased twice), and the pool ends with
    at most one slab a thread, every one of them free."""
    pool = host_slabs.SlabPool()
    threads = (os.cpu_count() or 1) + 3
    specs = [((64, 3), np.dtype(np.float32)), ((5,), np.dtype(np.int64))]
    bad = []

    def work(k: int) -> None:
        for i in range(150):
            a, b = pool.carve(specs)
            a[:] = k * 1000 + i
            b[:] = k
            if not ((a == k * 1000 + i).all() and (b == k).all()):
                bad.append((k, i))
            del a, b

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(threads) as ex:
            list(ex.map(work, range(threads)))
    finally:
        sys.setswitchinterval(old)
    assert not bad
    assert 1 <= len(pool) <= threads
    assert len(pool._free) == len(pool)
