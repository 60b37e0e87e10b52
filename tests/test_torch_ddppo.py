"""The port's DD-PPO PointNav controller against the JAX package's.

Full size (GroupNorm ResNet50 over 256^2 depth, hidden 512, 2-layer
LSTM), the JAX variables carried over by ``from_jax_variables``:
``PointNavResNetPolicy.act`` at B=2 with masks 1 and 0 (logits, value and
hidden state within 1e-4, the same argmax), ``DdppoController.plan`` over
10 steps, and the eval env with the controller in the loop (the same
actions and observations at every step). The weights are seeded and
symmetric, so that the argmax moves with the inputs. JAX compiles twice:
``act`` at B=2 and ``plan`` at B=1.
"""
import os

import jax
import numpy as np
import pytest
import torch

from ws_mgmap_tpu.config.default import get_config as jget_config
from ws_mgmap_tpu.env import dataset as jdataset
from ws_mgmap_tpu.env import environments as jenvironments
from ws_mgmap_tpu.models.ddppo_policy import DdppoController as JController
from ws_mgmap_tpu.models.ddppo_policy import PointNavResNetPolicy as JPolicy
from ws_mgmap_tpu_torch.config.default import get_config
from ws_mgmap_tpu_torch.env import dataset, environments, vector_env
from ws_mgmap_tpu_torch.models.ddppo_policy import (DdppoController,
                                                    PointNavResNetPolicy)
from ws_mgmap_tpu_torch.utils.convert import (from_jax_variables,
                                              load_torch_checkpoint)

TOL = 1e-4


def _inputs(rng, b):
    return (rng.rand(b, 256, 256, 1).astype(np.float32),
            np.stack([rng.rand(b) * 5, rng.randn(b)], 1).astype(np.float32),
            rng.randint(0, 4, b).astype(np.int32),
            rng.randn(4, b, 512).astype(np.float32))


def _random_variables(shapes, rng) -> dict:
    """Seeded weights for the variables' shapes, drawn in numpy: weights
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default, symmetric, where
    flax's LSTM init is all positive and leaves the argmax fixed), biases
    U(-0.1, 0.1), GroupNorm scales in [0.5, 1.5), embeddings N(0, 1)."""
    def draw(path, shape):
        leaf = path[-1]
        if leaf == "scale":
            return rng.rand(*shape) + 0.5
        if leaf == "bias" or "bias" in leaf.split(".")[-1]:
            return rng.uniform(-0.1, 0.1, shape)
        if leaf == "embedding":
            return rng.randn(*shape)
        # flax kernels are [..., in, out]; raw torch weights [out, in]
        fan_in = (int(np.prod(shape[:-1])) if leaf == "kernel"
                  else shape[1])
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, shape)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return draw(path, tree.shape).astype(np.float32)
    return walk(jax.tree.map(lambda x: x, shapes), ())


@pytest.fixture(scope="module")
def jax_run():
    """Seeded JAX variables and JAX's ``act`` on them at B=2 (one
    compile; the variables' shapes come from ``eval_shape``)."""
    rng = np.random.RandomState(9)
    depth, goal, prev, hidden = _inputs(rng, 2)
    masks = np.array([[1.0], [0.0]], np.float32)
    policy = JPolicy()
    shapes = jax.eval_shape(
        lambda k: policy.init(k, depth, goal, prev, hidden, masks,
                              method=JPolicy.act), jax.random.PRNGKey(0))
    variables = _random_variables(
        jax.tree.map(lambda x: x, shapes,
                     is_leaf=lambda x: hasattr(x, "shape")), rng)
    out = jax.jit(lambda v: policy.apply(v, depth, goal, prev, hidden, masks,
                                         method=JPolicy.act))(variables)
    return variables, (depth, goal, prev, hidden, masks), \
        [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def state_dict(jax_run):
    return from_jax_variables(jax_run[0])


def test_act_equals_jax(jax_run, state_dict):
    _, inputs, (j_action, j_logits, j_value, j_hidden) = jax_run
    policy = PointNavResNetPolicy()
    policy.load_state_dict(state_dict, strict=True)
    depth, goal, prev, hidden, masks = (torch.from_numpy(x) for x in inputs)
    with torch.no_grad():
        action, logits, value, new_hidden = policy.act(
            depth, goal, prev.long(), hidden, masks)
    np.testing.assert_allclose(logits.numpy(), j_logits, rtol=0, atol=TOL)
    np.testing.assert_allclose(value.numpy(), j_value, rtol=0, atol=TOL)
    np.testing.assert_allclose(new_hidden.numpy(), j_hidden, rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(action.numpy(), j_action)
    # the masked env's state was reset: its h and c came from zeros
    assert new_hidden.shape == (4, 2, 512)


def test_plan_equals_jax(jax_run, state_dict):
    jctrl = JController(variables=jax_run[0])
    ctrl = DdppoController(state_dict, device="cpu")
    rng = np.random.RandomState(3)
    want, got = [], []
    for t in range(10):
        depth = (rng.rand(256, 256, 1) * (0.3 + 0.07 * t)).astype(np.float32)
        goal = np.array([rng.rand() * 4, rng.randn() * 2])
        want.append(jctrl.plan(depth, goal, t))
        got.append(ctrl.plan(depth, goal, t))
    assert got == want
    assert len(set(got)) > 1, got  # the argmax moved
    np.testing.assert_allclose(ctrl.hidden.numpy(), np.asarray(jctrl.hidden),
                               rtol=0, atol=TOL)
    ctrl.reset()
    assert not ctrl.hidden.any() and int(ctrl.prev_action[0]) == 0


def test_env_with_controller_equals_jax(jax_run, state_dict):
    """The eval env with the DD-PPO controller in the loop, in process:
    the waypoint -> (rho, phi) -> discrete action path, step for step."""
    cfgs = []
    for get in (get_config, jget_config):
        cfg = get()
        cfg.use_ddppo = True
        cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = 34
        s = cfg.TASK_CONFIG.SIMULATOR
        s.RGB_SENSOR.WIDTH = s.RGB_SENSOR.HEIGHT = 64
        cfgs.append(cfg)
    ds = dataset.make_fake_dataset(2, ["fake/a"], seed=5)
    jds = jdataset.make_fake_dataset(2, ["fake/a"], seed=5)
    gt = dataset.fake_gt_locations(ds)
    penv = environments.VLNCEDaggerEnv(
        cfgs[0], ds, gt, auto_reset_done=False,
        controller=DdppoController(state_dict, device="cpu"))
    jenv = jenvironments.VLNCEDaggerEnv(
        cfgs[1], jds, gt, auto_reset_done=False,
        controller=JController(variables=jax_run[0]))
    po, jo = penv.reset(), jenv.reset()
    rng = np.random.RandomState(4)
    positions = []
    for t in range(34):
        inp = {"action": rng.randn(2), "prog": -1,
               "epidsode_reset_flag": t == 0, "depth_img": po["depth"]}
        po, _, pd, pi = penv.step(dict(inp))
        jo, _, jd, ji = jenv.step(dict(inp))
        assert pd == jd
        np.testing.assert_equal(pi, ji)
        for k in ("rgb", "depth", "gps", "compass", "waypoint", "progress"):
            np.testing.assert_array_equal(po[k], jo[k], err_msg=f"{t} {k}")
        st = penv.sim.get_agent_state()
        positions.append(tuple(st.position) + tuple(st.rotation))
        if pd:
            break
    assert penv._elapsed_steps > 24
    # after the look-around the controller moved or turned the agent
    assert len(set(positions[23:])) > 1


def test_from_torch_checkpoint_fills_every_parameter(tmp_path, state_dict):
    full = {f"actor_critic.{k}": v.clone() for k, v in state_dict.items()}
    full["other_module.weight"] = torch.ones(3)  # not under the prefix
    for i, blob in enumerate((full, {"state_dict": full, "extra": 1})):
        path = tmp_path / f"ddppo{i}.pth"
        torch.save(blob, path)
        ctrl = DdppoController.from_torch_checkpoint(str(path), device="cpu")
        got = ctrl.policy.state_dict()
        assert got.keys() == state_dict.keys()
        for k, v in state_dict.items():
            assert torch.equal(got[k], v), k
    # the UNet framing drops the first two parts of each key
    path = tmp_path / "unet.pt"
    torch.save({"models": {"img_segm_model": {
        "module.encoder.conv.weight": torch.arange(4.0)}}}, path)
    assert list(load_torch_checkpoint(str(path))) == ["conv.weight"]
    # a key of the policy missing from the file fails the strict load
    del full["actor_critic.critic.fc.bias"]
    torch.save(full, tmp_path / "partial.pth")
    with pytest.raises(RuntimeError, match="critic.fc.bias"):
        DdppoController.from_torch_checkpoint(str(tmp_path / "partial.pth"),
                                              device="cpu")


def test_controller_device_and_random_init(monkeypatch):
    if torch.cuda.is_available():
        assert DdppoController().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DdppoController()
    a, b, c = (DdppoController(seed=s, device="cpu") for s in (3, 3, 4))
    for (k, x), y, z in zip(a.policy.state_dict().items(),
                            b.policy.state_dict().values(),
                            c.policy.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(a.policy.net.visual_fc[1].weight,
                           c.policy.net.visual_fc[1].weight)
    # inside an env worker the controller runs on the CPU, with the
    # worker's share of the threads
    threads = torch.get_num_threads()
    monkeypatch.setenv(vector_env.ENV_WORKER, "2")
    try:
        cfg = get_config()
        cfg.DDPPO_CONTROLLER_CKPT = os.devnull + ".missing"
        ctrl = environments.VLNCEDaggerEnv._build_controller(cfg)
        assert ctrl.device.type == "cpu"
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(threads)
    assert vector_env.worker_threads(10 * (os.cpu_count() or 1)) == 1
    assert vector_env.worker_threads(1) == max(1, (os.cpu_count() or 1) // 2)
