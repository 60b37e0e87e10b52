"""The slice as a whole: the port's ``RolloutEngine.update_map`` vs the JAX
package's over a 4-step episode with a ``masks=0`` reset, in the fp32
parity mode and in the bf16 + rotate-in-splat production mode.

The weights come from ``from_jax_variables``. In the production mode both
packages force their fused-conv path on: the JAX Pallas kernels run in
interpret mode, the port's wrappers run their plain twins (CPU tensors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import (init_policy_variables, jax_config,
                                     port_config, port_policy)
from ws_mgmap_tpu.models.policy import BasePolicy as JPolicy
from ws_mgmap_tpu.ops import mapping as jmap
from ws_mgmap_tpu.ops.pallas import conv as jconv
from ws_mgmap_tpu.train.rollout import RolloutEngine as JEngine
from ws_mgmap_tpu.utils.convert import export_torch_state
from ws_mgmap_tpu_torch.models.policy import BasePolicy
from ws_mgmap_tpu_torch.ops.kernels import conv as kconv
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine
from ws_mgmap_tpu_torch.utils.convert import from_jax_variables

B = 2


def _episode(rng):
    """4 steps: a compass spin while the agent walks towards and past the
    map edge; env 0 starts a new episode at step 3."""
    steps = []
    for t in range(4):
        raw = []
        for i in range(B):
            depth = (rng.rand(128, 128, 1) * 0.5).astype(np.float32)
            depth[: 10 + 5 * i] = 0.0
            raw.append({
                "instruction": rng.randint(1, 50, 8),
                "rgb": rng.randint(0, 255, (64, 64, 3)).astype(np.float32),
                "depth": depth,
                "gps": np.array([0.9 * t - 0.3 * i, 0.6 * t * (1 - 2 * i)],
                                np.float32),
                "compass": np.array([0.4 * t - 1.1 * i], np.float32),
            })
        masks = np.ones((B, 1), np.float32)
        if t == 0:
            masks[:] = 0.0
        if t == 3:
            masks[0] = 0.0
        steps.append((raw, masks))
    return steps


@pytest.fixture(scope="module")
def weights():
    """The whole JAX policy's variables (``tests/torch_port_common.py``),
    whose UNet, the only module the map-update step runs, is initialized
    through ``update_map`` with its own non-trivial BN statistics and
    affines."""
    rng = np.random.RandomState(31)
    policy = JPolicy(jax_config())
    obs = {"rgb": jnp.zeros((1, 64, 64, 3)),
           "depth": jnp.zeros((1, 128, 128, 1)),
           "gps": jnp.zeros((1, 2)), "compass": jnp.zeros((1, 1))}
    init = jax.jit(lambda k: policy.init(
        k, obs, jnp.ones((1, 1)), jmap.init_global_map(1, policy.cfg.mapper),
        method=JPolicy.update_map))
    unet = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    for coll, leaf, make in (("batch_stats", "mean",
                              lambda s: rng.randn(*s) * 0.1),
                             ("batch_stats", "var",
                              lambda s: rng.rand(*s) + 0.5),
                             ("params", "scale",
                              lambda s: rng.rand(*s) + 0.5)):
        def walk(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v)
                elif k == leaf:
                    tree[k] = make(v.shape).astype(np.float32)
        walk(unet[coll])
    variables = init_policy_variables(0)
    for coll in ("params", "batch_stats"):
        variables[coll]["net"]["rgb_encoder"] = unet[coll]["net"][
            "rgb_encoder"]
    return variables


def test_weight_carry_over(weights):
    policy = BasePolicy(port_config())
    shapes = {k: tuple(v.shape) for k, v in policy.state_dict().items()}
    sd = from_jax_variables(weights)
    exported = export_torch_state(weights, reference_shapes=shapes)
    own = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert own == set(exported)
    assert any(k.startswith("net.rgb_encoder.") for k in own)
    for k in own:
        np.testing.assert_array_equal(sd[k].numpy(), exported[k], err_msg=k)
    policy.load_state_dict(sd, strict=True)
    assert set(policy.state_dict()) == set(sd)


def _run(weights, rotate, bf16, fused=None):
    jeng = JEngine(JPolicy(jax_config(rotate)), weights, B,
                   compute_dtype=jnp.bfloat16 if bf16 else None)
    teng = RolloutEngine(port_policy(weights, rotate), B, device="cpu",
                         compute_dtype=torch.bfloat16 if bf16 else None)
    if bf16 if fused is None else fused:
        jconv.set_fused_conv_mode("on")
        kconv.set_fused_conv_mode("on")
    out = []
    try:
        for raw, masks in _episode(np.random.RandomState(41)):
            jego = jeng.update_map(jeng.batch_obs(raw), masks)
            ego = teng.update_map(teng.batch_obs(raw), masks)
            assert ego.dtype == torch.float32
            assert teng.global_map.dtype == (torch.bfloat16 if bf16
                                             else torch.float32)
            out.append((np.asarray(jego, np.float32), ego.numpy(),
                        np.asarray(jeng.global_map, np.float32),
                        teng.global_map.float().numpy().copy()))
    finally:
        jconv.set_fused_conv_mode("auto")
        kconv.set_fused_conv_mode("auto")
    return out


def test_update_map_fp32_parity_mode(weights):
    for t, (jego, ego, jglob, glob) in enumerate(_run(weights, False, False)):
        # fp32 UNet sums in another order plus the grid_sample coordinate
        # rounding of the two rotations: 1e-4 of the map's range
        scale = float(np.abs(jglob).max())
        assert scale > 0
        np.testing.assert_allclose(ego, jego, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"ego step {t}")
        np.testing.assert_allclose(glob, jglob, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"global step {t}")


def test_update_map_fp32_fused_mode(weights, monkeypatch):
    # the fp32 fused path (fused mode "on" in both packages): JAX's Pallas
    # kernel in interpret mode against the port's direct-kernel twin
    calls = []
    direct = kconv.KERNELS["direct"]
    monkeypatch.setitem(kconv.KERNELS, "direct",
                        lambda *a, **k: calls.append(1) or direct(*a, **k))
    out = _run(weights, False, False, fused=True)
    # the UNet's eligible convs went through the direct kernel's wrapper
    assert calls
    for t, (jego, ego, jglob, glob) in enumerate(out):
        # fp32 on both sides, sums in other orders: 1e-4 of the range, as
        # in the library-conv parity mode
        scale = float(np.abs(jglob).max())
        assert scale > 0
        np.testing.assert_allclose(ego, jego, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"ego step {t}")
        np.testing.assert_allclose(glob, jglob, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"global step {t}")


def test_update_map_bf16_rotate_in_splat(weights):
    for t, (jego, ego, jglob, glob) in enumerate(_run(weights, True, True)):
        # exact binning: the global map's support is the same cell set.
        # The ego read-back is a bf16 bilinear rotation, where the port
        # rounds once and JAX in every blend step, so near-zero border
        # cells may round to 0 in one only (measured agreement >= 99.5%)
        np.testing.assert_array_equal(glob.any(-1), jglob.any(-1))
        assert (ego.any(-1) == jego.any(-1)).mean() >= 0.99, t
        # bf16 UNet features rounded at different points by the two
        # frameworks: measured worst element <1% of the range and mean
        # error <0.5% of the mean magnitude
        for got, want in ((ego, jego), (glob, jglob)):
            err = np.abs(got - want)
            assert err.max() <= 2e-2 * float(np.abs(want).max()), t
            assert err.mean() <= 1e-2 * float(np.abs(want).mean()), t
