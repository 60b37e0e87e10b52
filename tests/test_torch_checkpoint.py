"""Checkpoints across the two packages, the port's full-state resume, and
the port's batch collation vs the JAX package's, at the small widths of
``tests/torch_port_common.py`` on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import (SMALL, init_policy_variables, jax_batch,
                                     jax_config, port_config, port_policy,
                                     train_episodes)
from ws_mgmap_tpu.models.policy import BasePolicy as JPolicy
from ws_mgmap_tpu.train import checkpoint as jckpt
from ws_mgmap_tpu.train import replay as jreplay
from ws_mgmap_tpu.utils.convert import import_torch_state
from ws_mgmap_tpu_torch.models.policy import BasePolicy
from ws_mgmap_tpu_torch.train import checkpoint, replay, step
from ws_mgmap_tpu_torch.train.losses import MonitorConfig
from ws_mgmap_tpu_torch.utils.convert import CONV1D_WEIGHTS, PORTED_PREFIXES

H = SMALL["hidden_size"]


@pytest.fixture(scope="module")
def weights():
    return init_policy_variables(5)


@pytest.fixture(scope="module")
def batch():
    return replay.collate_episodes(
        train_episodes(np.random.RandomState(8), (4, 2)), t_bucket=1)


@jax.jit
def _jax_forward_seq_jit(variables, obs, masks):
    return JPolicy(jax_config()).apply(
        variables, obs, jnp.zeros((2, masks.shape[0], H)), masks, False,
        method=JPolicy.forward_seq)


def _jax_forward_seq(variables, batch):
    """JAX's forward_seq in eval mode (the running BN statistics)."""
    jb = jax_batch(batch)
    mean, aux = _jax_forward_seq_jit(variables, jb["obs"],
                                     jb["not_done_masks"])
    return np.asarray(mean), {k: np.asarray(v) for k, v in aux.items()}


def _port_forward_seq(policy, batch):
    obs = step.upload_batch(batch, torch.device("cpu"))["obs"]
    masks = torch.from_numpy(batch["not_done_masks"])
    with torch.no_grad():
        mean, aux = policy.eval().forward_seq(
            obs, torch.zeros(2, masks.shape[0], H), masks)
    return mean.numpy(), {k: v.numpy() for k, v in aux.items()}


def _assert_same_outputs(got, want):
    # eval mode, fp32; only summation orders differ
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_jax_checkpoint_loads_strictly(weights, batch, tmp_path):
    """A JAX ``save_checkpoint`` file ([out, in] key-layer weights, no
    ``num_batches_tracked``) fills every parameter and buffer of the
    port's policy, and the two give the same forward_seq."""
    path = str(tmp_path / "ckpt.3.pth")
    jckpt.save_checkpoint(path, weights, extra_state={"dagger_it": 1})
    raw = torch.load(path, weights_only=False)["state_dict"]
    assert not any(k.endswith("num_batches_tracked") for k in raw)
    assert all(raw["net." + k].dim() == 2 for k in CONV1D_WEIGHTS)

    policy = BasePolicy(port_config())
    blob = checkpoint.restore(policy, path, strict=True)
    assert blob["extra_state"] == {"dagger_it": 1}
    _assert_same_outputs(_port_forward_seq(policy, batch),
                         _jax_forward_seq(weights, batch))


def test_port_checkpoint_restores_in_jax(weights, batch, tmp_path):
    """The port's file restores in JAX with no key missing under the ported
    prefixes, and JAX then gives the port's forward_seq."""
    policy = port_policy(weights)
    # move the weights off the JAX ones, so the check sees the file's
    with torch.no_grad():
        for p in policy.parameters():
            p.mul_(1.01)
        for name, b in policy.named_buffers():
            if name.endswith("running_var"):
                b.add_(0.1)
    path = str(tmp_path / "ckpt.0.pth")
    checkpoint.save_checkpoint(path, policy, config={"a": 1})
    template = jax.tree.map(np.zeros_like, weights)
    variables, blob = jckpt.restore_variables(template, path)
    assert blob["config"] == {"a": 1}
    _, missing, unused = import_torch_state(template, blob["state_dict"])
    assert not [k for k in missing if k.startswith(PORTED_PREFIXES)]
    assert not unused
    _assert_same_outputs(_port_forward_seq(policy, batch),
                         _jax_forward_seq(variables, batch))


def test_native_resume_is_exact(weights, batch, tmp_path):
    """save_native after one update, load into a differently initialized
    state: the next update is bit-identical to the uninterrupted one."""
    update = step.make_train_step(MonitorConfig())
    state = step.create_train_state(port_policy(weights), device="cpu")
    update(state, batch)
    path = str(tmp_path / "native" / "state.pt")
    checkpoint.save_native(path, state)
    want = update(state, batch)

    torch.manual_seed(99)
    other = step.create_train_state(BasePolicy(port_config()), device="cpu")
    checkpoint.load_native(path, other)
    assert other.step == 1
    got = update(other, batch)
    assert other.step == state.step == 2
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in state.policy.state_dict().items():
        assert torch.equal(other.policy.state_dict()[k], v), k
    for a, b in zip(state.optimizer.state.values(),
                    other.optimizer.state.values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name,epochs", [("ckpt.9.pth", 10), ("ckpt.4.pth", 10),
                                         ("ckpt.0.pth", 1), ("other.pth", 5)])
def test_resume_point_and_latest_match_jax(tmp_path, name, epochs):
    blob = {"extra_state": {"dagger_it": 2}}
    assert (checkpoint.parse_resume_point(blob, name, epochs)
            == jckpt.parse_resume_point(blob, name, epochs))
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    for i, f in enumerate(("ckpt.1.pth", name)):
        (tmp_path / f).write_bytes(b"x")
        os.utime(tmp_path / f, (1000 + i, 1000 + i))
    assert (checkpoint.latest_checkpoint(str(tmp_path))
            == jckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / name))


@pytest.mark.parametrize("kw", [dict(), dict(t_bucket=4), dict(max_len=6),
                                dict(fixed_len=True, max_len=9)])
def test_collate_matches_jax(kw):
    """Same padding (fill 1.0: padded frames carry token 1 everywhere),
    T bucket, weights and masks as the JAX package's collate."""
    eps = train_episodes(np.random.RandomState(9), (7, 3, 5))
    got = replay.collate_episodes(eps, **kw)
    want = jreplay.collate_episodes(eps, **kw)
    assert set(got) == set(want) and set(got["obs"]) == set(want["obs"])
    for k in ("prev_actions", "weights", "not_done_masks"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in want["obs"].items():
        assert got["obs"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["obs"][k], v, err_msg=k)
    t = got["weights"].shape[1]
    if not kw:
        assert t == 16  # 7 rounded up to the 16-step bucket
        assert (got["obs"]["instruction"][1, 3:] == 1).all()
