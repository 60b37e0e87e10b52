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

from ws_mgmap_tpu.models.policy import BasePolicy as JPolicy
from ws_mgmap_tpu.models.policy import MGMapConfig as JConfig
from ws_mgmap_tpu.ops import mapping as jmap
from ws_mgmap_tpu.ops.pallas import conv as jconv
from ws_mgmap_tpu.train.rollout import RolloutEngine as JEngine
from ws_mgmap_tpu.utils.convert import export_torch_state
from ws_mgmap_tpu_torch.models.policy import BasePolicy, MGMapConfig
from ws_mgmap_tpu_torch.ops import mapping
from ws_mgmap_tpu_torch.ops.kernels import conv as kconv
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine
from ws_mgmap_tpu_torch.utils.convert import from_jax_variables

B = 2
MAP = dict(ego_size=20, global_size=48, map_depth=8)
WIDTH = 0.125  # 8-channel proj_feat == map_depth


def _jax_cfg(rotate):
    return JConfig(
        vocab_size=50, instr_hidden=16, rgb_output_size=32,
        depth_output_size=16, map_output_size=32, ego_map_size=20,
        map_depth=8, hidden_size=64, unet_width=WIDTH,
        mapper=jmap.MapperParams(**MAP, rotate_in_splat=rotate,
                                 splat_backend="pallas" if rotate else "auto"))


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
    rng = np.random.RandomState(31)
    policy = JPolicy(_jax_cfg(False))
    obs = {"rgb": jnp.zeros((1, 64, 64, 3)),
           "depth": jnp.zeros((1, 128, 128, 1)),
           "gps": jnp.zeros((1, 2)), "compass": jnp.zeros((1, 1))}
    init = jax.jit(lambda k: policy.init(
        k, obs, jnp.ones((1, 1)), jmap.init_global_map(1, policy.cfg.mapper),
        method=JPolicy.update_map))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    # non-trivial BN statistics and affines
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
        walk(variables[coll])
    return variables


def test_weight_carry_over(weights):
    sd = from_jax_variables(weights)
    exported = export_torch_state(weights)
    own = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert own == {k for k in exported if k.startswith("net.rgb_encoder.")}
    for k in own:
        np.testing.assert_array_equal(sd[k].numpy(), exported[k], err_msg=k)
    policy = BasePolicy(MGMapConfig(unet_width=WIDTH, map_depth=8,
                                    mapper=mapping.MapperParams(**MAP)))
    policy.load_state_dict(sd, strict=True)
    assert set(policy.state_dict()) == set(sd)


def _run(weights, rotate, bf16):
    jcfg = _jax_cfg(rotate)
    cfg = MGMapConfig(unet_width=WIDTH, map_depth=8,
                      mapper=mapping.MapperParams(**MAP,
                                                  rotate_in_splat=rotate))
    policy = BasePolicy(cfg)
    policy.load_state_dict(from_jax_variables(weights), strict=True)
    jeng = JEngine(JPolicy(jcfg), weights, B,
                   compute_dtype=jnp.bfloat16 if bf16 else None)
    teng = RolloutEngine(policy, B, device="cpu",
                         compute_dtype=torch.bfloat16 if bf16 else None)
    if bf16:
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
