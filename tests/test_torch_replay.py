"""The port's replay pipeline against the JAX package's: the records the
writer side packs, and the batches ``ReplayLoader`` yields for every rank
of 1, 2 and 3, bit for bit."""
import numpy as np
import pytest

from tests.torch_port_common import train_episodes
from ws_mgmap_tpu.train import replay as jreplay
from ws_mgmap_tpu_torch.data.trajstore import TrajStoreWriter, pack_record
from ws_mgmap_tpu_torch.train import replay

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
