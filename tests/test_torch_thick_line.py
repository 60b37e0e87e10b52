"""The port's thick-line raster (``env/sensors.py::draw_line``) and the
oracle path sensor at ``LINE_WIDTH`` above 1, against OpenCV and the JAX
package's ``PathSensor`` (which draws with ``cv2.line``), CPU.

Held:
  * ``draw_line`` sets exactly the pixels ``cv2.line(img, p0, p1, 255,
    width)`` sets, at widths 1-5, 7 and 20, on seeded segments of a
    100x100 grid whose ends lie inside, near or far outside the image,
    degenerate and very short ones among them;
  * the path sensor at ``LINE_WIDTH`` 1-5 equals JAX's on seeded FakeSim
    agent states and goals, some paths leaving the 100x100 window: the
    raster exactly (distance 0 on the path), the distances within
    ``test_torch_env.GT_PATH_ATOL`` of OpenCV's float32 transform.
"""
import math
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from ws_mgmap_tpu.config.default import get_config as jget_config
from ws_mgmap_tpu.env import sensors as jsensors
from ws_mgmap_tpu.env import sim as jsim
from ws_mgmap_tpu_torch.config.default import get_config
from ws_mgmap_tpu_torch.env import sensors, sim

GT_PATH_ATOL = 2e-5  # as tests/test_torch_env.py


def _segments(rng, n):
    for k in range(n):
        span = (0, 100) if k % 3 == 0 else ((-40, 140) if k % 3 == 1
                                            else (-300, 400))
        a = tuple(int(v) for v in rng.randint(*span, 2))
        b = tuple(int(v) for v in rng.randint(*span, 2))
        if k % 13 == 0:
            b = a
        elif k % 7 == 0:
            b = (a[0] + int(rng.randint(-3, 4)), a[1] + int(rng.randint(-3, 4)))
        yield a, b


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 7, 20])
def test_draw_line_equals_cv2_line(width):
    rng = np.random.RandomState(100 + width)
    for a, b in _segments(rng, 1500):
        want = np.zeros((100, 100), np.uint8)
        cv2.line(want, a, b, 255, width)
        got = np.zeros((100, 100), np.uint8)
        sensors.draw_line(got, a, b, width)
        assert np.array_equal(got, want), (width, a, b)


def _path_sensors(width):
    cfgs = []
    for get in (jget_config, get_config):
        cfg = get().TASK_CONFIG.TASK.VLN_ORACLE_PATH_SENSOR.clone()
        cfg.LINE_WIDTH = width
        cfgs.append(cfg)
    return jsensors.PathSensor(cfgs[0]), sensors.PathSensor(cfgs[1])


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5])
def test_path_sensor_width_equals_jax(width):
    jsensor, psensor = _path_sensors(width)
    js = jsim.FakeSim("fake/thick", rgb_hw=(8, 8), depth_hw=(8, 8))
    ps = sim.FakeSim("fake/thick", rgb_hw=(8, 8), depth_hw=(8, 8))
    rng = np.random.RandomState(width)
    on_edge = 0
    for _ in range(12):
        start = js.scene.sample_navigable(rng)
        goal = js.scene.sample_navigable(rng)
        yaw = float(rng.uniform(-math.pi, math.pi))
        rot = np.array([0.0, math.sin(yaw / 2), 0.0, math.cos(yaw / 2)])
        episode = SimpleNamespace(goals=[{"position": goal.tolist()}])
        for s in (js, ps):
            s.reset_agent(start, rot)
        want = jsensor(js, episode, None)
        got = psensor(ps, episode, None)
        assert (got.dtype, got.shape) == (want.dtype, want.shape)
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=GT_PATH_ATOL)
        z = got == 0
        on_edge += bool(z[0].any() or z[-1].any() or z[:, 0].any()
                        or z[:, -1].any())
    assert on_edge  # some paths leave the window: their segments clip
