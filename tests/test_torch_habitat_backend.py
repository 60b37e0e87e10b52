"""The port's habitat-sim adapter (``env/habitat_backend.py``) against the
JAX package's, both driven through the stub ``habitat_sim`` of
``tests/test_habitat_backend.py`` (its classes and fixture, imported):
the same settings from each package's task config, the same calls and
configs reaching the stub's simulator, the same agent states, geodesics,
paths and ``render()`` dicts (depth clipped and normalised exactly), and
the same episode through ``construct_envs`` with ``SIMULATOR.TYPE
"Sim-v0"``. Without habitat-sim the adapter raises ``ImportError`` and
nothing falls back to FakeSim."""
import types

import numpy as np
import pytest

import tests.test_habitat_backend as stub
from tests.test_habitat_backend import habitat_backend  # noqa: F401
from ws_mgmap_tpu.config.default import get_config as jget_config
from ws_mgmap_tpu.env import dataset as jdataset
from ws_mgmap_tpu.env import vector_env as jvector_env
from ws_mgmap_tpu_torch.config.default import get_config
from ws_mgmap_tpu_torch.env import dataset, vector_env
from ws_mgmap_tpu_torch.env import habitat_backend as hb
from ws_mgmap_tpu_torch.env.sim import FakeSim


@pytest.fixture()
def backends(habitat_backend, monkeypatch):  # noqa: F811
    """(port module, JAX module), both over the stub."""
    monkeypatch.setattr(hb, "HABITAT_AVAILABLE", True)
    stub._MockSim.created.clear()
    return hb, habitat_backend


def _sim_cfg(get, semantic=False):
    cfg = get()
    cfg.defrost()
    if semantic:
        cfg.TASK_CONFIG.SIMULATOR.AGENT_0.SENSORS.append("SEMANTIC_SENSOR")
    return cfg.TASK_CONFIG.SIMULATOR


def test_sensor_settings_equal_jax(backends):
    port, jax_hb = backends
    for semantic in (False, True):
        got = port._sensor_settings(_sim_cfg(get_config, semantic))
        want = jax_hb._sensor_settings(_sim_cfg(jget_config, semantic))
        assert got == want and got["want_semantic"]
    assert port._sensor_settings(None) == jax_hb._sensor_settings(None)
    assert port._DEFAULTS == jax_hb._DEFAULTS
    odd = types.SimpleNamespace(
        DEPTH_SENSOR=types.SimpleNamespace(MIN_DEPTH=0.5, MAX_DEPTH=5,
                                           HEIGHT=64, WIDTH=96),
        TURN_ANGLE=30, HABITAT_SIM_V0=types.SimpleNamespace(
            ALLOW_SLIDING=False))
    assert port._sensor_settings(odd) == jax_hb._sensor_settings(odd)


def test_adapter_calls_equal_jax(backends, monkeypatch):
    port, jax_hb = backends
    depth = np.random.RandomState(0).uniform(-1, 12, (256, 256))
    real_obs = stub._MockSim.get_sensor_observations

    def observations(self):
        return dict(real_obs(self), depth_sensor=depth.astype(np.float32))

    monkeypatch.setattr(stub._MockSim, "get_sensor_observations",
                        observations)
    sims = []
    for mod, get, min_d, max_d in ((port, get_config, 0.5, 5.0),
                                   (jax_hb, jget_config, 0.5, 5.0)):
        cfg = _sim_cfg(get, semantic=True)
        cfg.DEPTH_SENSOR.MIN_DEPTH, cfg.DEPTH_SENSOR.MAX_DEPTH = min_d, max_d
        sims.append(mod.HabitatSimBackend("scenes/X.glb", sim_cfg=cfg))
    (got, want), (sim_p, sim_j) = sims, stub._MockSim.created
    assert sim_p.cfg == sim_j.cfg and got.settings == want.settings
    assert (got.forward_step, got.turn_angle_deg) == (
        want.forward_step, want.turn_angle_deg)
    rng = np.random.RandomState(1)
    for _ in range(5):
        pos = rng.uniform(-3, 3, 3).tolist()
        yaw = rng.uniform(-np.pi, np.pi)
        rot = [np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0]
        for b in (got, want):
            b.reset_agent(pos, rot)
            for a in (0, 1, 2, 1, 3, 1):
                b.step(a)
        sg, sw = got.get_agent_state(), want.get_agent_state()
        assert type(sg).__module__.startswith("ws_mgmap_tpu_torch")
        np.testing.assert_array_equal(sg.position, sw.position)
        np.testing.assert_array_equal(sg.rotation, sw.rotation)
        a, b = rng.uniform(-5, 5, 3), rng.uniform(-5, 5, 3)
        assert got.geodesic_distance(a, b) == want.geodesic_distance(a, b)
        for p, q in zip(got.get_straight_shortest_path_points(a, b),
                        want.get_straight_shortest_path_points(a, b)):
            np.testing.assert_array_equal(p, q)
        assert got.is_navigable(a) == want.is_navigable(a)
    assert sim_p.steps == sim_j.steps and len(sim_p.steps) == 25
    assert got.last_collided == want.last_collided
    rp, rj = got.render(), want.render()
    assert sorted(rp) == sorted(rj) == ["depth", "rgb", "semantic"]
    for k in rp:
        assert rp[k].dtype == rj[k].dtype, k
        np.testing.assert_array_equal(rp[k], rj[k], err_msg=k)
    want_depth = (np.clip(depth.astype(np.float32), 0.5, 5.0) - 0.5) / 4.5
    np.testing.assert_array_equal(rp["depth"][..., 0], want_depth)
    assert got.semantic_annotations().objects[1].category.index() == 3
    for name in ("reset_agent", "get_agent_state", "step", "render",
                 "geodesic_distance", "get_straight_shortest_path_points",
                 "is_navigable", "forward_step", "turn_angle_deg"):
        assert hasattr(port.HabitatSimBackend, name)
        assert hasattr(FakeSim, name)


def _episode(ds_mod):
    start, goal = [0.0, 0.0, 0.0], [0.0, 0.0, -3.0]
    path = [start, [0.0, 0.0, -1.5], goal]
    ep = ds_mod.Episode(
        episode_id="hab0", scene_id="scenes/X.glb", start_position=start,
        start_rotation=[0.0, 0.0, 0.0, 1.0],
        goals=[{"position": goal, "radius": 3.0}],
        instruction={"instruction_text": "go forward",
                     "instruction_tokens": [5, 7, 9] + [0] * 197},
        reference_path=path, info={"geodesic_distance": 3.75})
    return ds_mod.VLNCEDataset([ep]), {"hab0": {"locations": path}}


def _drive(get, ds_mod, construct):
    cfg = get()
    cfg.defrost()
    cfg.NUM_PROCESSES = 1
    cfg.TASK_CONFIG.SIMULATOR.TYPE = "Sim-v0"
    cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = 60
    cfg.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
    cfg.TASK_CONFIG.TASK.SENSORS.append("SEMANTIC_FILTER_SENSOR")
    cfg.TASK_CONFIG.SIMULATOR.AGENT_0.SENSORS.append("SEMANTIC_SENSOR")
    cfg.freeze()
    ds, gt = _episode(ds_mod)
    envs = construct(cfg, ds, gt, auto_reset_done=False, workers=False)
    obs = envs.reset()
    trace = [obs[0]]
    for step in range(60):
        wp = np.asarray(obs[0]["waypoint"], np.float32)[:2]
        out = envs.step([{"action": np.arctanh(np.clip(wp, -0.99, 0.99)),
                          "prog": -1.0, "epidsode_reset_flag": step == 0}])
        obs = [o[0] for o in out]
        trace.append(obs[0])
        if out[0][2]:
            break
    envs.close()
    return trace, out[0][3]


def test_env_stack_on_the_adapter_equals_jax(backends):
    trace, info = _drive(get_config, dataset, vector_env.construct_envs)
    jtrace, jinfo = _drive(jget_config, jdataset, jvector_env.construct_envs)
    sim_p, sim_j = stub._MockSim.created
    assert sim_p.steps == sim_j.steps and sim_p.steps[:24] == [
        "turn_left"] * 24
    assert info == jinfo and info["success"] == 1.0
    assert len(trace) == len(jtrace) > 25
    for o, jo in zip(trace, jtrace):
        assert sorted(o) == sorted(jo)
        assert o["semantic_filter"].shape == (224, 224, 27)
        for k in ("rgb", "depth", "gps", "compass", "waypoint",
                  "semantic_filter"):
            np.testing.assert_array_equal(o[k], jo[k], err_msg=k)


def test_without_habitat_sim_raises():
    assert not hb.HABITAT_AVAILABLE  # no habitat-sim on this machine
    with pytest.raises(ImportError, match="habitat_sim"):
        hb.HabitatSimBackend("scenes/X.glb", sim_cfg=_sim_cfg(get_config))
    cfg = get_config()
    cfg.defrost()
    cfg.NUM_PROCESSES = 1
    cfg.TASK_CONFIG.SIMULATOR.TYPE = "Sim-v0"
    cfg.freeze()
    ds, gt = _episode(dataset)
    with pytest.raises(ImportError, match="habitat_sim"):
        vector_env.construct_envs(cfg, ds, gt, workers=False)
