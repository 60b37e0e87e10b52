"""The port's whole policy vs the JAX package's at small widths
(``tests/torch_port_common.py``): the weight carry-over of every module,
``MGMapNet.forward`` on the cached-features path, and ``BasePolicy.act``
through the live mapping step, every output field. fp32; the tolerances
are those the JAX package is held to against the torch reference
(``tests/test_policy_parity.py``: atol 2e-3, rtol 1e-3; ``att_map`` atol
2e-4) or tighter where the runs allow, as stated per check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import (SMALL, init_policy_variables,
                                     jax_config, port_config, port_policy,
                                     raw_obs, tokens)
from ws_mgmap_tpu.models.policy import BasePolicy as JPolicy
from ws_mgmap_tpu.models.policy import MGMapNet as JNet
from ws_mgmap_tpu.utils.convert import export_torch_state
from ws_mgmap_tpu_torch.models.policy import BasePolicy
from ws_mgmap_tpu_torch.utils.convert import from_jax_variables

B, H = 3, SMALL["hidden_size"]


@pytest.fixture(scope="module")
def weights():
    return init_policy_variables(0)


def test_from_jax_variables_whole_policy(weights):
    policy = BasePolicy(port_config())
    shapes = {k: tuple(v.shape) for k, v in policy.state_dict().items()}
    sd = from_jax_variables(weights)
    exported = export_torch_state(weights, reference_shapes=shapes)
    own = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert own == set(exported)
    for k in own:
        np.testing.assert_array_equal(sd[k].numpy(), exported[k], err_msg=k)
    for k in ("net.state_text_k_layer.weight", "net.text_map_k_layer.weight"):
        assert sd[k].shape == (H // 2, sd[k].shape[1], 1), k
    assert {k.split(".")[0] for k in sd} == {
        "net", "action_distribution", "critic", "prog_pred"}
    policy.load_state_dict(sd, strict=True)
    assert set(policy.state_dict()) == set(sd)
    for k, v in policy.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


def _close(got: torch.Tensor, want, atol: float, rtol: float, what: str):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rtol,
                               atol=atol, err_msg=what)


def test_mgmapnet_forward_cached_features(weights):
    rng = np.random.RandomState(12)
    instr = tokens(rng, B, (7, 0, 24))  # a zero-length and a full row
    obs = {"instruction": instr,
           "rgb_features": rng.randn(B, 2, 2, 64).astype(np.float32),
           "depth_features": rng.randn(B, 2, 2, 128).astype(np.float32),
           "rgb_ego_map": rng.rand(B, 20, 20, 8).astype(np.float32)}
    hidden = rng.randn(2, B, H).astype(np.float32)
    masks = np.array([[1.0], [0.0], [1.0]], np.float32)
    net_vars = {c: weights[c]["net"] for c in weights}
    want = JNet(jax_config()).apply(
        net_vars, {k: jnp.asarray(v) for k, v in obs.items()},
        jnp.asarray(hidden), jnp.asarray(masks), False)
    net = port_policy(weights).net.eval()
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in obs.items()},
                  torch.from_numpy(hidden), torch.from_numpy(masks))
    assert got[5] is None and want[5] is None  # no mapping step
    # measured worst (abs): 1.2e-7 on features and hidden, 4.5e-8 on the
    # semantic logits, 7.5e-9 on the attention weights
    for i, name in enumerate(("features", "hidden", "pred_sem_map")):
        _close(got[i], want[i], 2e-5, 1e-5, name)
    _close(got[3], want[3], 1e-7, 1e-5, "att_map")
    np.testing.assert_array_equal(got[4].numpy(), obs["rgb_ego_map"])


def test_act_matches_jax(weights):
    rng = np.random.RandomState(13)
    raw = raw_obs(rng, B, 1, tokens(rng, B, (5, 24, 11)))
    batch = {k: np.stack([np.asarray(o[k]) for o in raw]) for k in raw[0]}
    hidden = rng.randn(2, B, H).astype(np.float32)
    masks = np.array([[1.0], [0.0], [1.0]], np.float32)
    gmap = np.abs(rng.randn(B, 48, 48, 8)).astype(np.float32)
    gmap[:, :, :30] = 0.0

    jpol = JPolicy(jax_config())
    want = jax.jit(lambda v, o, h, m, g: jpol.apply(
        v, o, h, m, g, True, method=JPolicy.act))(
            weights, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(hidden), jnp.asarray(masks), jnp.asarray(gmap))
    policy = port_policy(weights).eval()
    with torch.no_grad():
        got = policy.act({k: torch.from_numpy(v) for k, v in batch.items()},
                         torch.from_numpy(hidden), torch.from_numpy(masks),
                         torch.from_numpy(gmap.copy()))
    # measured worst (abs): 5.7e-7 on the heads and hidden state, 7.5e-9
    # on the attention weights; on the maps and the trunks' features
    # (rotation coordinates and deep convs rounded in other orders) 8.5e-6
    # of the range
    scaled = {"ego_map", "global_map", "rgb_features", "depth_features"}
    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        if field in scaled:
            _close(g, w, 2e-5 * float(np.abs(w).max()), 0.0, field)
        else:
            _close(g, w, 1e-7 if field == "att_map" else 2e-5, 1e-5, field)
    assert float(got.global_map.abs().max()) > 0
