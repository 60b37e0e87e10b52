"""The port's host stack against the JAX package's, bit for bit on seeded
inputs: FakeSim, the dataset and its splits, every sensor and measure at
every step of seeded episodes, the episode envs with auto-reset on and
off, ``construct_envs``' scene splits and the forkserver ``VectorEnv``.

The one exception is the oracle path sensor (``gt_path``): the JAX package
rasterises with ``cv2.line`` and takes ``cv2.distanceTransform``; the port
has its own raster (exact: the path's pixels, where the distance is 0,
are the same) and SciPy's exact distance transform (within 2e-5 of
OpenCV's ``DIST_MASK_PRECISE``, which rounds in float32). The raster is
also held equal to ``cv2.line`` on 12,000 seeded segments with ends off
the image (thicker lines: ``tests/test_torch_thick_line.py``).
"""
import dataclasses
import gzip
import json
import math
import time

import cv2
import numpy as np
import pytest

from ws_mgmap_tpu.config.default import get_config as jget_config
from ws_mgmap_tpu.env import dataset as jdataset
from ws_mgmap_tpu.env import environments as jenvironments
from ws_mgmap_tpu.env import sim as jsim
from ws_mgmap_tpu.env import vector_env as jvector_env
from ws_mgmap_tpu.train.trainer import load_split as jload_split
from ws_mgmap_tpu_torch.config.default import get_config
from ws_mgmap_tpu_torch.env import dataset, environments, sim, vector_env
from ws_mgmap_tpu_torch.env.sensors import PathSensor, draw_line, line_pixels
from ws_mgmap_tpu_torch.train.trainer import load_split

GT_PATH_ATOL = 2e-5
SMALL_SIM = dict(rgb=64, depth=128)
SCENES = ["fake/a", "fake/b", "fake/c"]


def _config(get, *, processes=2, max_steps=40, sensors_extra=(),
            small=True):
    cfg = get()
    cfg.defrost()
    cfg.NUM_PROCESSES = processes
    cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = max_steps
    cfg.TASK_CONFIG.TASK.SENSORS = (list(cfg.TASK_CONFIG.TASK.SENSORS)
                                    + list(sensors_extra))
    if small:
        s = cfg.TASK_CONFIG.SIMULATOR
        s.RGB_SENSOR.WIDTH = s.RGB_SENSOR.HEIGHT = SMALL_SIM["rgb"]
        s.DEPTH_SENSOR.WIDTH = s.DEPTH_SENSOR.HEIGHT = SMALL_SIM["depth"]
    return cfg


def _sim_factory(pkg_sim, cfg):
    s = cfg.TASK_CONFIG.SIMULATOR
    return lambda scene: pkg_sim.FakeSim(
        scene, rgb_hw=(s.RGB_SENSOR.HEIGHT, s.RGB_SENSOR.WIDTH),
        depth_hw=(s.DEPTH_SENSOR.HEIGHT, s.DEPTH_SENSOR.WIDTH))


def _episode_tuple(ep):
    return dataclasses.astuple(ep)


@pytest.fixture(scope="module")
def datasets():
    """6 FakeSim episodes on 3 scenes from each package, made once: the
    scenes keep their distance fields for the tests that follow."""
    return (dataset.make_fake_dataset(6, SCENES, seed=0),
            jdataset.make_fake_dataset(6, SCENES, seed=0))


def assert_obs_equal(want: dict, got: dict, where=""):
    assert want.keys() == got.keys(), where
    for k in want:
        w, g = want[k], got[k]
        if k == "instruction":
            assert w["text"] == g["text"], where
            np.testing.assert_array_equal(g["tokens"], w["tokens"])
            continue
        w, g = np.asarray(w), np.asarray(g)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), (where, k)
        if k == "gt_path":
            # the raster exactly (distance 0 on the path), the distances
            # within float32 rounding of OpenCV's
            np.testing.assert_array_equal(g == 0, w == 0,
                                          err_msg=f"{where} raster")
            np.testing.assert_allclose(g, w, rtol=0, atol=GT_PATH_ATOL,
                                       err_msg=f"{where} gt_path")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


# ---------------------------------------------------------------------------
# the raster
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed, span", [(0, 30), (1, 30), (2, 3000),
                                        (3, 130), (4, 1)],
                         ids=["near0", "near1", "far", "mid", "inside"])
def test_raster_equals_cv2_line(seed, span):
    """2,400 segments a case on a 100x100 grid, ends in [-span, 100+span):
    the pixels ``cv2.line(img, p0, p1, 255, 1)`` sets, exactly."""
    rng = np.random.RandomState(seed)
    for _ in range(2400):
        p = rng.randint(-span, 100 + span, 4)
        a, b = (int(p[0]), int(p[1])), (int(p[2]), int(p[3]))
        want = np.zeros((100, 100), np.uint8)
        cv2.line(want, a, b, 255, 1)
        got = np.zeros((100, 100), np.uint8)
        for x, y in line_pixels(a, b, 100, 100):
            got[y, x] = 255
        assert np.array_equal(got, want), (a, b)


def test_raster_on_rectangles():
    rng = np.random.RandomState(5)
    for _ in range(1000):
        w, h = (int(v) for v in rng.randint(1, 120, 2))
        p = rng.randint(-200, 200, 4)
        a, b = (int(p[0]), int(p[1])), (int(p[2]), int(p[3]))
        want = np.zeros((h, w), np.uint8)
        cv2.line(want, a, b, 255, 1)
        got = np.zeros((h, w), np.uint8)
        for x, y in line_pixels(a, b, w, h):
            got[y, x] = 255
        assert np.array_equal(got, want), (w, h, a, b)


def test_path_sensor_only_takes_width_one():
    """Named for when the port raised on any other width. It now takes
    ``LINE_WIDTH`` 2 and draws it as ``cv2.line`` does (every width 1-5
    against JAX's sensor: ``tests/test_torch_thick_line.py``)."""
    cfg = get_config().TASK_CONFIG.TASK.VLN_ORACLE_PATH_SENSOR.clone()
    cfg.LINE_WIDTH = 2
    assert PathSensor(cfg).line_width == 2
    want = np.zeros((100, 100), np.uint8)
    cv2.line(want, (-5, 20), (70, 104), 255, 2)
    got = np.zeros((100, 100), np.uint8)
    draw_line(got, (-5, 20), (70, 104), 2)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# FakeSim and the dataset
# ---------------------------------------------------------------------------
def test_fakesim_equals_jax():
    rng = np.random.RandomState(11)
    for scene in ("fake/sceneA", "fake/val_seen_1"):
        js = jsim.FakeSim(scene, rgb_hw=(48, 64), depth_hw=(40, 56))
        ps = sim.FakeSim(scene, rgb_hw=(48, 64), depth_hw=(40, 56))
        np.testing.assert_array_equal(ps.scene.occ, js.scene.occ)
        np.testing.assert_array_equal(ps.scene.sem, js.scene.sem)
        starts = [js.scene.sample_navigable(np.random.RandomState(i))
                  for i in range(3)]
        for k, start in enumerate(starts):
            goal = starts[(k + 1) % 3]
            rot = np.array([math.cos(0.3 * k), 0.0, math.sin(0.3 * k), 0.0])
            for s in (js, ps):
                s.reset_agent(start, rot)
                if k:
                    s.set_goal(goal)
            for step in range(12):
                for key, w in js.render().items():
                    np.testing.assert_array_equal(ps.render()[key], w)
                jst, pst = js.get_agent_state(), ps.get_agent_state()
                np.testing.assert_array_equal(pst.position, jst.position)
                np.testing.assert_array_equal(pst.rotation, jst.rotation)
                assert ps.last_collided == js.last_collided
                a = jst.position
                assert ps.geodesic_distance(a, goal) == \
                    js.geodesic_distance(a, goal)
                jp = js.get_straight_shortest_path_points(a, goal)
                pp = ps.get_straight_shortest_path_points(a, goal)
                assert len(pp) == len(jp)
                for x, y in zip(pp, jp):
                    np.testing.assert_array_equal(x, y)
                action = int(rng.randint(0, 4))
                js.step(action)
                ps.step(action)


def test_dataset_equals_jax(tmp_path, datasets):
    got, want = datasets
    assert ([_episode_tuple(e) for e in got.episodes]
            == [_episode_tuple(e) for e in want.episodes])
    assert dataset.fake_gt_locations(got) == jdataset.fake_gt_locations(want)
    assert got.scenes() == want.scenes() == SCENES
    for num, rank in ((2, 0), (2, 1), (3, 2)):
        assert ([_episode_tuple(e) for e in
                 got.split_by_rank(num, rank).episodes]
                == [_episode_tuple(e) for e in
                    want.split_by_rank(num, rank).episodes])
    assert ([e.episode_id for e in got.filter_scenes(SCENES[1:]).episodes]
            == [e.episode_id for e in
                want.filter_scenes(SCENES[1:]).episodes])
    for n in (1, 2, 3, 5):
        assert (dataset.round_robin_scene_split(SCENES * 2, n)
                == jdataset.round_robin_scene_split(SCENES * 2, n))

    # the file format: both packages read the same json.gz alike
    eps = got.episodes
    blob = {"episodes": [dataclasses.asdict(e) for e in eps],
            "instruction_vocab": {"word_list": ["<PAD>", "go", "left"]}}
    path = tmp_path / "val_seen.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(blob, f)
    want = jdataset.VLNCEDataset.from_file(str(path))
    got = dataset.VLNCEDataset.from_file(str(path))
    assert got.vocab == want.vocab == ["<PAD>", "go", "left"]
    assert ([_episode_tuple(e) for e in got.episodes]
            == [_episode_tuple(e) for e in want.episodes])


def test_load_split_equals_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no data/ here: the FakeSim splits
    for split in ("val_unseen",):
        cfg, jcfg = get_config(), jget_config()
        for c in (cfg, jcfg):
            c.TASK_CONFIG.DATASET.FAKE_EPISODES = 4
            c.TASK_CONFIG.DATASET.FAKE_SCENES = 3
            c.TASK_CONFIG.DATASET.FAKE_SEED_OFFSET = 2
        (ds, gt), (jds, jgt) = load_split(cfg, split), jload_split(jcfg, split)
        assert gt == jgt and len(ds.episodes) == 4
        assert ([_episode_tuple(e) for e in ds.episodes]
                == [_episode_tuple(e) for e in jds.episodes])
    # from files when they exist
    eps = dataset.make_fake_dataset(3, ["fake/a"], seed=2)
    (tmp_path / "d").mkdir()
    with gzip.open(tmp_path / "d/val_seen.json.gz", "wt") as f:
        json.dump({"episodes": [dataclasses.asdict(e)
                                for e in eps.episodes]}, f)
    with gzip.open(tmp_path / "d/val_seen_gt.json.gz", "wt") as f:
        json.dump(dataset.fake_gt_locations(eps), f)
    cfg, jcfg = get_config(), jget_config()
    for c in (cfg, jcfg):
        c.TASK_CONFIG.DATASET.DATA_PATH = str(tmp_path / "d/{split}.json.gz")
        c.TASK_CONFIG.TASK.NDTW.GT_PATH = str(
            tmp_path / "d/{split}_gt.json.gz")
    (ds, gt), (jds, jgt) = load_split(cfg, "val_seen"), jload_split(
        jcfg, "val_seen")
    assert gt == jgt == json.loads(json.dumps(dataset.fake_gt_locations(eps)))
    assert ([_episode_tuple(e) for e in ds.episodes]
            == [_episode_tuple(e) for e in jds.episodes])


@pytest.mark.parametrize("shuffle", [True, False])
def test_episode_iterator_order_equals_jax(shuffle, datasets):
    ds = datasets[0]
    for seed, cycle in ((0, True), (5, False)):
        want = jenvironments.EpisodeIterator(ds.episodes, shuffle, seed,
                                             cycle)
        got = environments.EpisodeIterator(ds.episodes, shuffle, seed, cycle)
        for _ in range(17):
            w, g = want.next_episode(), got.next_episode()
            assert (g and g.episode_id) == (w and w.episode_id)


# ---------------------------------------------------------------------------
# sensors and measures at every step, through the episode envs
# ---------------------------------------------------------------------------
def _drive(jenv, penv, steps: int, rng, policy: str):
    """Step both envs with the same inputs; every observation, reward,
    done and measure must match. ``policy``: "oracle" (the oracle
    waypoint), or "random" (random waypoints and, after the look-around,
    a random progress now and then, which can stop the episode)."""
    jo, po = jenv.reset(), penv.reset()
    assert_obs_equal(jo, po, "reset")
    dones = 0
    for t in range(steps):
        if policy == "oracle":
            action = np.arctanh(np.clip(po["waypoint"], -0.99, 0.99))
            prog = -1.0
        else:
            action = rng.randn(2) * 1.5
            prog = float(rng.rand()) if rng.rand() < 0.1 else -1.0
        inp = {"action": action, "prog": prog,
               "epidsode_reset_flag": t == 0, "depth_img": po["depth"]}
        jo, jr, jd, ji = jenv.step(dict(inp))
        po, pr, pd, pi = penv.step(dict(inp))
        assert (pr, pd) == (jr, jd), t
        np.testing.assert_equal(pi, ji)
        assert_obs_equal(jo, po, f"{policy} step {t}")
        assert penv.current_episode().episode_id == \
            jenv.current_episode().episode_id
        dones += pd
        if pd and not penv.auto_reset_done:
            jo, po = jenv.reset(), penv.reset()
            assert_obs_equal(jo, po, f"reset after step {t}")
    return dones


@pytest.mark.parametrize("policy, auto_reset", [("oracle", True),
                                                ("random", False)])
def test_env_episodes_equal_jax(policy, auto_reset, datasets):
    extra = ("SEMANTIC_FILTER_SENSOR",)
    cfg = _config(get_config, max_steps=26, sensors_extra=extra)
    jcfg = _config(jget_config, max_steps=26, sensors_extra=extra)
    ds, jds = datasets
    gt = dataset.fake_gt_locations(ds)
    penv = environments.VLNCEDaggerEnv(
        cfg, ds, gt, sim_factory=_sim_factory(sim, cfg),
        auto_reset_done=auto_reset, seed=3)
    jenv = jenvironments.VLNCEDaggerEnv(
        jcfg, jds, gt, sim_factory=_sim_factory(jsim, jcfg),
        auto_reset_done=auto_reset, seed=3)
    dones = _drive(jenv, penv, 40, np.random.RandomState(8), policy)
    assert dones >= 1  # an episode ended and the next one began


def test_inference_env_equals_jax(datasets):
    cfg, jcfg = _config(get_config), _config(jget_config)
    ds, jds = datasets
    penv = environments.VLNCEInferenceEnv(
        cfg, ds, None, sim_factory=_sim_factory(sim, cfg),
        auto_reset_done=False)
    jenv = jenvironments.VLNCEInferenceEnv(
        jcfg, jds, None, sim_factory=_sim_factory(jsim, jcfg),
        auto_reset_done=False)
    _drive(jenv, penv, 8, np.random.RandomState(2), "random")
    info = penv.get_metrics()
    assert set(info) == {"position", "heading", "stop"}
    assert info == jenv.get_metrics()


# ---------------------------------------------------------------------------
# vectorised envs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("processes", [1, 2, 3, 4])
def test_construct_envs_scene_splits_equal_jax(processes, datasets):
    """Whole scenes dealt round robin; more envs than scenes gives every
    env the whole split."""
    ds, jds = datasets
    cfg = _config(get_config, processes=processes)
    jcfg = _config(jget_config, processes=processes)
    envs = vector_env.construct_envs(cfg, ds, workers=False)
    jenvs = jvector_env.construct_envs(jcfg, jds, workers=False)
    assert envs.num_envs == jenvs.num_envs == processes
    got = [[e.episode_id for e in env.dataset.episodes] for env in envs._envs]
    want = [[e.episode_id for e in env.dataset.episodes]
            for env in jenvs._envs]
    assert got == want
    assert [env.iterator.rng.get_state()[1].sum() for env in envs._envs] == \
        [env.iterator.rng.get_state()[1].sum() for env in jenvs._envs]
    envs.close()
    jenvs.close()


def test_other_simulators_raise(datasets):
    """Another simulator goes to the habitat adapter, which raises
    without habitat-sim (none here): no FakeSim in its place."""
    cfg = _config(get_config)
    cfg.TASK_CONFIG.SIMULATOR.TYPE = "Sim-v0"
    with pytest.raises(ImportError, match="habitat_sim"):
        vector_env.construct_envs(cfg, datasets[0], workers=False)


def test_forkserver_workers_pause_resume_and_close(datasets):
    """Two worker processes against the same envs in process: the same
    observations through a step, a pause, a resume and another step; then
    the workers exit within close()'s timeout. (In process, ``call``
    reads each env's result: the JAX package's copy returns the last
    env's for every env, so it is not the reference here.)"""
    cfg = _config(get_config, processes=2)
    ds = datasets[0]
    gt = dataset.fake_gt_locations(ds)
    inline = vector_env.construct_envs(cfg, ds, gt, workers=False)
    envs = vector_env.construct_envs(cfg, ds, gt, workers=True)
    try:
        for a, b in zip(envs.reset(), inline.reset()):
            assert_obs_equal(b, a, "reset")
        step = {"action": np.array([0.2, 0.4]), "prog": -1}
        for a, b in zip(envs.step([step] * 2), inline.step([step] * 2)):
            assert_obs_equal(b[0], a[0], "step")
            assert a[1:3] == b[1:3]
            np.testing.assert_equal(a[3], b[3])
        for v in (envs, inline):
            v.pause_at(0)
        assert envs.num_envs == 1
        a, b = envs.step([step])[0], inline.step([step])[0]
        assert_obs_equal(b[0], a[0], "paused step")
        for v in (envs, inline):
            v.resume_all()
        assert envs.num_envs == 2
        assert ([e.episode_id for e in envs.current_episodes()]
                == [e.episode_id for e in inline.current_episodes()])
        assert envs.number_of_episodes == inline.number_of_episodes
        assert sum(envs.number_of_episodes) == len(ds.episodes)
        assert envs.call("get_metrics") == inline.call("get_metrics")
    finally:
        t0 = time.perf_counter()
        envs.close()
        inline.close()
    assert time.perf_counter() - t0 < 10.0
    for p in envs._procs:
        p.join(timeout=5)
        assert not p.is_alive()
