"""DAgger collection (``train/collector.py``) against the JAX package's
``collect_dataset``, on the same weights, the same FakeSim split and the
same mixing generator (``RandomState(1000)``), each package's engine on
the CPU in fp32 with in-process envs (``workers=False``), at the port's
small end-to-end configuration (``tools/synthetic.py::TINY_OPTS``: 2
envs, a 20^2 ego map, 64^2 RGB, 128^2 depth), episodes of at most 36
steps. The weights are drawn in numpy for the JAX variables' shapes and
carried over with ``from_jax_variables``.

Held:
  * beta = 1 (oracle-driven): 3 episodes on 2 envs, the second env
    paused when its iterator wraps (the batch falls to 1). Every
    step's actions, the stores record by record (each observation key,
    ``prev_actions``, ``oracle_actions``, ``ep_id`` equal; the fp16
    caches ``rgb_features``, ``depth_features`` and ``rgb_ego_map`` within
    1 fp16 ulp of each value plus the fp32 error they carry before the
    cast, 5e-5 of the array's range: near zero that fp32 error alone
    spans hundreds of fp16 ulps, 0 against 1.5e-5 say) and
    ``collected_ep.txt`` equal;
  * beta = 0.75: step by step, every waypoint within the fp32 act
    tolerance of ``test_torch_act.py`` up to the first step whose
    discrete action differs (the agents' states after it differ), which
    must be a flip within tolerance, reported;
  * the exactly-once dedup of ``tests/test_collector.py`` with a stub
    engine returning torch tensors;
  * each package's ``ReplayLoader`` reads the other's store into equal
    batches.
"""
import os

import numpy as np
import pytest
import torch

from tests.torch_port_common import random_variables, tiny_configs
from ws_mgmap_tpu.data.trajstore import TrajStoreReader as JReader
from ws_mgmap_tpu.data.trajstore import unpack_record as junpack
from ws_mgmap_tpu.models.policy import BasePolicy as JPolicy
from ws_mgmap_tpu.models.policy import MGMapConfig as JMGMapConfig
from ws_mgmap_tpu.train import collector as jcollector
from ws_mgmap_tpu.train.replay import ReplayLoader as JLoader
from ws_mgmap_tpu.train.rollout import RolloutEngine as JEngine
from ws_mgmap_tpu.train.trainer import load_split as jload_split
from ws_mgmap_tpu_torch.data.trajstore import TrajStoreReader, unpack_record
from ws_mgmap_tpu_torch.models.policy import BasePolicy, MGMapConfig
from ws_mgmap_tpu_torch.train import collector
from ws_mgmap_tpu_torch.train.replay import ReplayLoader
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine
from ws_mgmap_tpu_torch.train.trainer import load_split
from ws_mgmap_tpu_torch.utils.convert import from_jax_variables

CACHES = ("rgb_features", "depth_features", "rgb_ego_map")
ACT_RTOL, ACT_ATOL = 1e-5, 2e-5  # test_torch_act.py's fp32 waypoints
# the caches' fp32 error before the cast, of the array's range: the
# GroupNorm ResNet50 depth trunk on FakeSim frames differed by up to
# 2.5e-5 between the packages (each package's fp32 against float64: 6.6e-6
# and 1.1e-5 on a first frame), over test_torch_act.py's 2e-5
CACHE_ATOL = 5e-5
RGB_HW, DEPTH_HW = 64, 128       # TINY_OPTS' sensors
# episodes of at most 36 steps: records of the look-around's end and 4
# decisions
SHORT = ["ep_max_len", "36", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "36"]
BETA1_OPTS = ["DAGGER.UPDATE_SIZE", "3", "TASK_CONFIG.DATASET.FAKE_EPISODES",
              "3"] + SHORT
BETA075_OPTS = ["DAGGER.UPDATE_SIZE", "1", "DAGGER.P", "0.75"] + SHORT


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's torch work on one CPU thread: the policy is small,
    and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recorder:
    """A vector env that logs each step's actions, and the agents' gps
    and compass and the dones after it."""

    def __init__(self, envs, log: list):
        self.envs, self.log = envs, log

    def __getattr__(self, name):
        return getattr(self.envs, name)

    def step(self, inputs):
        out = self.envs.step(inputs)
        self.log.append(dict(
            actions=np.stack([np.asarray(x["action"], np.float32)
                              for x in inputs]),
            states=np.stack([np.concatenate([o[0]["gps"], o[0]["compass"]])
                             for o in out]),
            dones=[o[2] for o in out]))
        return out


def recording(monkeypatch, module, log: list) -> None:
    """``module``'s ``construct_envs`` returns a :class:`Recorder`."""
    real = module.construct_envs
    monkeypatch.setattr(module, "construct_envs",
                        lambda *a, **k: Recorder(real(*a, **k), log))


@pytest.fixture(scope="module")
def engines():
    """(the JAX engine, the port's) on the same weights, B=2; the JAX
    engine's compiles are shared by the module's runs."""
    pcfg, jcfg = tiny_configs("unused")
    mcfg = JMGMapConfig.from_config(jcfg.MODEL)
    variables = random_variables(mcfg, 11, RGB_HW, DEPTH_HW)
    policy = BasePolicy(MGMapConfig.from_config(pcfg.MODEL))
    policy.load_state_dict(from_jax_variables(variables), strict=True)
    return (JEngine(JPolicy(mcfg), variables, 2),
            RolloutEngine(policy, 2, device="cpu"))


def collect_both(engines, tmp_dir, opts, data_it):
    """Each package's collection from an empty store; returns {name:
    (store dir, step log, episodes appended)}."""
    pcfg, jcfg = tiny_configs(str(tmp_dir), opts)
    out = {}
    for name, mod, cfg, eng, split_fn in (
            ("jax", jcollector, jcfg, engines[0], jload_split),
            ("port", collector, pcfg, engines[1], load_split)):
        log: list = []
        with pytest.MonkeyPatch.context() as mp:
            recording(mp, mod, log)
            ds, gt = split_fn(cfg, cfg.TASK_CONFIG.DATASET.SPLIT)
            store = cfg.DAGGER.LMDB_FEATURES_DIR
            n = mod.collect_dataset(cfg, eng, ds, gt, store, data_it,
                                    workers=False,
                                    rng=np.random.RandomState(1000),
                                    log_fn=lambda s: None)
        out[name] = (store, log, n)
    return out


@pytest.fixture(scope="module")
def beta1(engines, tmp_path_factory):
    return collect_both(engines, tmp_path_factory.mktemp("beta1"),
                        BETA1_OPTS, 0)


def cache_error(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| of two fp16 arrays over its tolerance: 1
    fp16 ulp of the larger magnitude, plus ``CACHE_ATOL`` of the range of
    ``want``."""
    a, b = got.astype(np.float32), want.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
    tol = ulp.astype(np.float32) + CACHE_ATOL * np.abs(b).max()
    return float((np.abs(a - b) / tol).max())


def records(store: str, reader_cls, unpack) -> list:
    r = reader_cls(store)
    try:
        return [unpack(r.get(i)) for i in range(len(r))]
    finally:
        r.close()


def test_beta1_store_equals_jax(beta1):
    (jstore, jlog, jn), (pstore, plog, pn) = beta1["jax"], beta1["port"]
    assert pn == jn == 3
    # oracle-driven: the same actions and states at every step, and the
    # batch fell to 1 when the second env's iterator wrapped
    assert len(plog) == len(jlog)
    for t, (p, j) in enumerate(zip(plog, jlog)):
        np.testing.assert_array_equal(p["actions"], j["actions"], f"step {t}")
        np.testing.assert_array_equal(p["states"], j["states"], f"step {t}")
        assert p["dones"] == j["dones"], t
    assert len(plog[0]["actions"]) == 2 and len(plog[-1]["actions"]) == 1

    with open(os.path.join(pstore, "collected_ep.txt")) as f:
        port_ids = f.read()
    with open(os.path.join(jstore, "collected_ep.txt")) as f:
        assert port_ids == f.read()
    assert len(port_ids.split()) == 3

    prec = records(pstore, TrajStoreReader, unpack_record)
    jrec = records(jstore, JReader, junpack)
    assert len(prec) == len(jrec) == 3
    worst = 0
    for i, (p, j) in enumerate(zip(prec, jrec)):
        assert sorted(p) == sorted(j) == ["ep_id", "obs", "oracle_actions",
                                          "prev_actions"]
        assert str(p["ep_id"]) == str(j["ep_id"])
        for k in ("prev_actions", "oracle_actions"):
            np.testing.assert_array_equal(p[k], j[k], f"record {i} {k}")
        assert sorted(p["obs"]) == sorted(j["obs"])
        assert set(CACHES) < set(p["obs"])
        for k, v in p["obs"].items():
            want = j["obs"][k]
            assert v.dtype == want.dtype and v.shape == want.shape, (i, k)
            if k in CACHES:
                assert v.dtype == np.float16
                err = cache_error(v, want)
                worst = max(worst, err)
                assert err <= 1, (i, k, err)
            else:
                np.testing.assert_array_equal(v, want, f"record {i} {k}")
    print(f"beta=1: 3 records equal, caches within {worst:.3f} of the "
          "tolerance")


def test_beta075_steps_match_jax(engines, tmp_path, record_property):
    runs = collect_both(engines, tmp_path, BETA075_OPTS, 1)
    (_, jlog, _), (_, plog, _) = runs["jax"], runs["port"]
    compared, flips = 0, []
    for t, (p, j) in enumerate(zip(plog, jlog)):
        assert p["actions"].shape == j["actions"].shape, t
        np.testing.assert_allclose(p["actions"], j["actions"], rtol=ACT_RTOL,
                                   atol=ACT_ATOL, err_msg=f"step {t}")
        compared += 1
        if not (np.array_equal(p["states"], j["states"])
                and p["dones"] == j["dones"]):
            # a waypoint within tolerance turned into another action
            flips.append(dict(step=t, port=p["actions"].tolist(),
                              jax=j["actions"].tolist()))
            break
    else:
        assert len(plog) == len(jlog)
    record_property("steps_compared", compared)
    record_property("flips", flips)
    print(f"beta=0.75: {compared} steps compared, flips {flips}")
    assert compared >= 24


class _StubOutputs:
    def __init__(self, n):
        self.action = torch.zeros((n, 2))
        self.rgb_features = torch.zeros((n, 2, 2, 4))
        self.depth_features = torch.zeros((n, 2, 2, 2))
        self.ego_map = torch.zeros((n, 4, 4, 2))


class _StubEngine:
    """The RolloutEngine surface collect_dataset touches, returning torch
    tensors as the port's engine does."""

    def __init__(self):
        self.num_envs = 0

    def reset_state(self, n):
        self.num_envs = n

    def batch_obs(self, observations):
        return observations  # the collector treats the batch as opaque

    def act(self, batch, masks):
        return _StubOutputs(len(batch))

    def update_map(self, batch, masks):
        return torch.zeros((len(batch), 4, 4, 2))

    def zero_hidden_at(self, idx):
        pass

    def keep(self, keep_indices):
        self.num_envs = len(keep_indices)


def test_beta1_dedup_exactly_once(tmp_path):
    """``tests/test_collector.py``'s check against the port: every episode
    id appears exactly once in the store and in ``collected_ep.txt``, and
    each record holds the instruction of the episode its id names."""
    cfg, _ = tiny_configs(str(tmp_path), ["DAGGER.UPDATE_SIZE", "4"] + SHORT)
    dataset, gt = load_split(cfg, cfg.TASK_CONFIG.DATASET.SPLIT)
    store = str(tmp_path / "traj")
    collected = collector.collect_dataset(cfg, _StubEngine(), dataset, gt,
                                          store, 0, workers=False,
                                          log_fn=lambda s: None)
    assert collected >= 1

    with open(os.path.join(store, "collected_ep.txt")) as fp:
        log_ids = [ln.strip() for ln in fp if ln.strip()]
    assert len(log_ids) == len(set(log_ids)), f"duplicate ids in log: {log_ids}"
    assert set(log_ids) <= {e.episode_id for e in dataset.episodes}

    recs = records(store, TrajStoreReader, unpack_record)
    assert len(recs) == collected == len(log_ids)
    rec_ids = [str(np.asarray(r["ep_id"]).item()) for r in recs]
    assert sorted(rec_ids) == sorted(log_ids)
    by_id = {e.episode_id: e for e in dataset.episodes}
    for r, eid in zip(recs, rec_ids):
        instr = by_id[eid].instruction
        want = np.asarray(
            instr["instruction_tokens"] if isinstance(instr, dict)
            else instr.instruction_tokens, np.int64)
        got = np.asarray(r["obs"]["instruction"][0], np.int64)
        t = min(want.shape[0], got.shape[0])
        assert np.array_equal(got[:t], want[:t]), (
            f"record labeled {eid} holds another episode's instruction")
    # the stub's fp16 caches went in channels-last as the engine gave them
    assert recs[0]["obs"]["rgb_ego_map"].shape[1:] == (4, 4, 2)
    assert recs[0]["obs"]["rgb_ego_map"].dtype == np.float16


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_loaders_read_either_store(beta1, writer):
    """Each package's ``ReplayLoader`` on a store either package wrote:
    the same batches, leaf for leaf."""
    store = beta1[writer][0]
    for seed in (0, 1):
        got = list(ReplayLoader(store, 2, max_len=60, seed=seed))
        want = list(JLoader(store, 2, max_len=60, seed=seed))
        assert len(got) == len(want) == 1

        def same(a, b, path):
            if isinstance(a, dict):
                assert sorted(a) == sorted(b), path
                for k in a:
                    same(a[k], b[k], path + "/" + k)
            else:
                assert a.dtype == b.dtype, path
                np.testing.assert_array_equal(a, b, path)
        same(got[0], want[0], writer)
